"""The last scripts of the JAX package, ported (``tools/`` and ``cli/`` of the
port): each held against the JAX tool's own functions on the same numpy
inputs where it computes something JAX computes, and each tool's ``main``
run on the CPU at a small size."""

import contextlib
import functools
import importlib
import importlib.util
import io
import os
import shutil
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pixelwiseregression_tpu.models import PixelwiseRegression as JaxModel
from pixelwiseregression_tpu.models.layers import _instance_norm
from pixelwiseregression_tpu_torch.cli import check_samples, get_sfr, test_samples
from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.serve import Predictor
from pixelwiseregression_tpu_torch.serve_artifact import ServingArtifact, export_artifact
from pixelwiseregression_tpu_torch.serve_http import make_server
from pixelwiseregression_tpu_torch.tools import bench_http, bench_upsample_add, check_data_layout
from pixelwiseregression_tpu_torch.tools import headconv_bwd_split as hs
from pixelwiseregression_tpu_torch.train.checkpoint import save_checkpoint

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")
DATASETS = ("MSRA", "ICVL", "NYU", "HAND17")
SMALL = ["--features", "16", "--level", "2", "--joints", "5"]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Each dataset's fixture, generated once (not written to afterwards:
    tests that build indices take copies)."""
    out = {}
    for name in DATASETS:
        root = str(tmp_path_factory.mktemp(f"gen_{name.lower()}"))
        subprocess.run([sys.executable, os.path.join(FIXTURES, f"make_{name.lower()}_fixture.py"),
                        root], check=True, capture_output=True, timeout=300,
                       env=torch_port_threads.env())
        out[name] = root
    return out


def _copy(generated, tmp_path, name, tag=""):
    root = str(tmp_path / f"{name.lower()}{tag}")
    shutil.copytree(generated[name], root)
    return root


# --------------------------------------------------------------------------- #
# headconv_bwd_split against the JAX tool's functions
# --------------------------------------------------------------------------- #


def _jax_variants(x, w, scale, bias, r):
    """The JAX tool's variants (``tools/headconv_bwd_split.py:44-118``), rebuilt
    from ``_instance_norm`` and ``lax.conv_general_dilated``, returning
    values in place of the scan's scalar sums; the unit casts to x's dtype
    (the tool's bf16)."""
    f32 = jnp.float32

    def conv(x, w):
        return lax.conv_general_dilated(x, w.astype(x.dtype), (1, 1), ((1, 1), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def unit(x, w, scale, bias):
        return jax.nn.relu(_instance_norm(conv(x, w), scale, bias, 1e-5)).astype(x.dtype)

    def loss_conv(x, w):
        return jnp.sum(conv(x, w).astype(f32) * r.astype(f32))

    def loss_unit(x, w, scale, bias):
        return jnp.sum(unit(x, w, scale, bias).astype(f32) * r.astype(f32))

    def loss_normrelu(x, scale, bias):
        return jnp.sum(jax.nn.relu(_instance_norm(x, scale, bias, 1e-5)).astype(f32)
                       * r.astype(f32))

    def dw_dot9(x, dy):
        b, h, wd, c = x.shape
        xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
        return jnp.stack([jnp.stack([lax.dot_general(
            lax.dynamic_slice(xp, (0, i, j, 0), (b, h, wd, c)), dy,
            (((0, 1, 2), (0, 1, 2)), ((), ())), preferred_element_type=f32)
            for j in range(3)]) for i in range(3)])

    return {
        "fwd": [jnp.sum(unit(x, w, scale, bias).astype(f32))],
        "convpair": list(jax.grad(loss_conv, argnums=(0, 1))(x, w)),
        "dx_only": [jax.grad(loss_conv, argnums=0)(x, w)],
        "dw_only": [jax.grad(loss_conv, argnums=1)(x, w)],
        "unit_bwd": list(jax.grad(loss_unit, argnums=(0, 1, 2, 3))(x, w, scale, bias)),
        "normrelu": list(jax.grad(loss_normrelu, argnums=(0, 1, 2))(x, scale, bias)),
        "dw_dot9": [dw_dot9(x, r)],
    }


def test_headconv_variants_match_jax():
    """Every variant's value and gradients at [2, 8, 8, 16] f32, scale and
    bias drawn, against jax.grad of the JAX tool's functions on the same
    numpy inputs: rtol 1e-4, atol 1e-6 of the output's scale (at least 1e-6:
    dW sums 128 pixels to a scale of ~36, and an element near 0 after that
    sum carries f32 summation-order noise of ~1e-7 of the scale); dw_dot9
    equals dw_only to 1e-5 relative."""
    x, w, _, _, r = hs.inputs(2, "cpu", seed=3, side=8, channels=16, dtype=torch.float32)
    rng = np.random.RandomState(4)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 16).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 16).astype(np.float32))
    want = _jax_variants(*(jnp.asarray(t.numpy()) for t in (x, w, scale, bias, r)))
    for name in hs.VARIANTS:
        got = hs.values(name, x, w, scale, bias, r)
        assert len(got) == len(want[name]), name
        for g, j in zip(got, want[name]):
            j = np.asarray(j)
            np.testing.assert_allclose(g.detach().numpy(), j, rtol=1e-4,
                                       atol=1e-6 * max(1.0, float(np.abs(j).max())), err_msg=name)
    dot9, dw = hs.values("dw_dot9", x, w, scale, bias, r)[0], hs.values("dw_only", x, w, scale,
                                                                       bias, r)[0]
    assert float((dot9 - dw).abs().max() / dw.abs().max()) <= 1e-5
    assert hs.summary({v: 1.0 for v in hs.VARIANTS}, 2)[0].startswith("  convpair+normrelu")


# --------------------------------------------------------------------------- #
# bench_upsample_add
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_add_forms_match_each_other_and_jax(dtype):
    """The repeat and fused forms equal each other and the JAX tool's two
    forms to the bit (NCHW here, NHWC there)."""
    h, x = bench_upsample_add.inputs(2, 4, 8, "cpu", dtype=dtype, seed=5)
    got = {name: fn(h, x) for name, fn in bench_upsample_add.FORMS.items()}
    assert torch.equal(got["repeat"], got["fused"])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    hj, xj = (jnp.asarray(t.float().permute(0, 2, 3, 1).numpy(), jdt) for t in (h, x))
    rep = jnp.repeat(jnp.repeat(hj, 2, axis=1), 2, axis=2) + xj
    b, s, _, c = hj.shape
    fused = (xj.reshape(b, s, 2, s, 2, c) + hj[:, :, None, :, None, :]).reshape(b, 2 * s, 2 * s, c)
    for j in (rep, fused):
        np.testing.assert_array_equal(got["fused"].float().permute(0, 2, 3, 1).numpy(),
                                      np.asarray(j.astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# check_data_layout
# --------------------------------------------------------------------------- #


def _jax_layout_tool():
    path = os.path.join(REPO, "tools", "check_data_layout.py")
    spec = importlib.util.spec_from_file_location("jax_check_data_layout", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


@pytest.mark.parametrize("name", DATASETS)
def test_check_data_layout_passes_each_fixture(generated, tmp_path, name):
    """Exit 0 on each fixture, a decoded line a split; where the JAX tool
    checks the same files (all but HAND17) its output is the same."""
    root = _copy(generated, tmp_path, name)
    rc, lines = _run_main(check_data_layout.main, ["--dataset", name, "--data_path", root])
    assert rc == 0 and lines[-1] == f"LAYOUT OK for {name} at {root}", lines
    assert [line.split(":")[0] for line in lines[:-1]] == ["train", "test"]
    if name != "HAND17":
        jroot = _copy(generated, tmp_path, name, "_jax")
        jrc, jlines = _run_main(_jax_layout_tool().main, ["--dataset", name, "--data_path", jroot])
        assert (jrc, [line.replace(jroot, root) for line in jlines]) == (rc, lines)


REMOVED = {"MSRA": ["P3", os.path.join("P5", "1", "joint.txt")],
           "NYU": ["nyu_center_test.txt", os.path.join("test", "depth_1_0000001.png")],
           "ICVL": ["icvl_train_list.txt", os.path.join("Testing", "test_seq_2.txt")]}


@pytest.mark.parametrize("name", sorted(REMOVED))
def test_check_data_layout_reports_removed_files_as_jax(generated, tmp_path, name):
    """Files removed from a fixture: exit 1 and the numbered problem list,
    the same as the JAX tool's on the same layout."""
    roots = []
    for tag in ("", "_jax"):
        root = _copy(generated, tmp_path, name, tag)
        for rel in REMOVED[name]:
            path = os.path.join(root, rel)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
        roots.append(root)
    rc, lines = _run_main(check_data_layout.main, ["--dataset", name, "--data_path", roots[0]])
    jrc, jlines = _run_main(_jax_layout_tool().main, ["--dataset", name, "--data_path", roots[1]])
    assert rc == 1 and lines[0] == f"LAYOUT INVALID for {name} at {roots[0]}:", lines
    assert len(lines) == 1 + len(REMOVED[name]) and lines[1].startswith("  1. missing ")
    assert (jrc, [line.replace(roots[1], roots[0]) for line in jlines]) == (rc, lines)


def test_check_data_layout_reads_hand17_annotations_where_the_sources_do(generated, tmp_path):
    """HAND17's Training_Annotation.txt is read from training/ by the sources
    (both packages'): the port checks it there and reports it missing from
    there; the JAX tool looks at the root and refuses the valid fixture."""
    root = _copy(generated, tmp_path, "HAND17")
    jrc, jlines = _run_main(_jax_layout_tool().main, ["--dataset", "HAND17", "--data_path", root,
                                                      "--no_decode_sample"])
    assert jrc == 1 and jlines[1] == \
        f"  1. missing Training_Annotation.txt: {os.path.join(root, 'Training_Annotation.txt')}"
    os.remove(os.path.join(root, "training", "Training_Annotation.txt"))
    problems, decoded = check_data_layout.check("HAND17", root)
    assert problems == ["missing training/Training_Annotation.txt: "
                        + os.path.join(root, "training", "Training_Annotation.txt")]
    assert not decoded


# --------------------------------------------------------------------------- #
# the viewers: get_sfr and test_samples against the JAX model
# --------------------------------------------------------------------------- #

LABEL = 32
# batch norm: in eval mode an affine, whose f32 forward does not amplify the
# two frameworks' rounding. With instance norms on the fixture's crops (wide
# constant regions) the f32 port and JAX models part by 3e-4 to 3e-3 of the
# maps' scale at stage 2 (4e-4 to 7e-4 at stage 1), the norms' known
# amplification of rounding (tests/test_torch_port_model.py bounds it)
VIEW = ["--label_size", str(LABEL), "--features", "16", "--level", "2", "--stages", "2",
        "--norm_method", "batch", "--device", "cpu"]


def _draw(shapes, seed):
    """JAX variables of the tree ``shapes`` (``jax.eval_shape`` of the
    model's init: no compile) drawn from numpy: conv kernels N(0, 1/fan_in),
    norm scales about 1, biases and running means about 0, running variances
    in [0.5, 1.5], the softmax temperature 1."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:])
        if "kernel" in name:
            a = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif "scale" in name:
            a = 1 + 0.1 * rng.normal(size=s.shape)
        elif "var" in name:
            a = rng.uniform(0.5, 1.5, s.shape)
        elif "'w'" in name:
            a = np.ones(s.shape)
        else:
            a = 0.1 * rng.normal(size=s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def viewer(generated, tmp_path_factory):
    """A copy of the NYU fixture, a working directory whose Model/ holds two
    checkpoints of JAX weights (batch norm) carried across by the bridge,
    and the JAX model's apply with the variables."""
    work = str(tmp_path_factory.mktemp("viewer"))
    root = os.path.join(work, "nyu")
    shutil.copytree(generated["NYU"], root)
    jm = JaxModel(joints=14, stage=2, label_size=LABEL, features=16, level=2,
                  norm_method="batch", decoder="xla")
    zeros = [jnp.zeros((1, 2 * LABEL, 2 * LABEL, 1)), jnp.zeros((1, LABEL, LABEL, 1)),
             jnp.zeros((1, LABEL, LABEL, 1))]
    shapes = jax.eval_shape(functools.partial(jm.init, train=False), jax.random.PRNGKey(0), *zeros)
    os.makedirs(os.path.join(work, "Model"))
    variables = {}
    for seed, suffix in ((1, "mix"), (2, "default")):
        v = variables[suffix] = _draw(shapes, seed)
        model = PixelwiseRegression(14, stage=2, features=16, level=2, norm_method="batch")
        model.load_state_dict(state_dict_from_flax(v))
        save_checkpoint(os.path.join(work, "Model", f"NYU_{suffix}_final.pt"), model)
    apply = jax.jit(functools.partial(jm.apply, train=False))
    return {"work": work, "root": root, "variables": variables, "apply": apply}


@contextlib.contextmanager
def _cwd(path):
    prev = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(prev)


def _scale_gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_get_sfr_maps_match_jax(viewer, capsys):
    """get_sfr's heatmaps and depth maps of each checkpoint found (a missing
    suffix skipped with the JAX message) against the JAX model's on the same
    preprocessed batch, f32, within 1e-4 of each map's scale; its main
    writes the figure under Agg."""
    argv = ["--data_path", viewer["root"], "--suffixes", "detection", "mix", "default",
            "--num_samples", "1", *VIEW]
    with _cwd(viewer["work"]):
        data, rows = get_sfr.maps(get_sfr.parse_args(argv))
        assert "skipping detection: no checkpoint NYU_detection_final" in capsys.readouterr().out
        assert [r[0] for r in rows] == ["mix", "default"]
        for suffix, hm, dm in rows:
            out = viewer["apply"](viewer["variables"][suffix], data["img"], data["label_img"],
                                  data["mask"])[-1]
            assert hm.shape == (1, LABEL, LABEL, 14)
            assert _scale_gap(hm, np.asarray(out[0])) <= 1e-4, suffix
            assert _scale_gap(dm, np.asarray(out[1])) <= 1e-4, suffix
        assert get_sfr.main(argv + ["--out", "Result/sfr_test.png"]) == 0
        assert os.path.getsize("Result/sfr_test.png") > 0
        with pytest.raises(SystemExit):
            get_sfr.maps(get_sfr.parse_args(argv[:3] + argv[6:]))


def test_test_samples_uvd_matches_jax(viewer, tmp_path):
    """test_samples' predicted uvd against the JAX model's on the same
    preprocessed sample, f32, within 1e-4 of its scale; the headless main
    saves a canvas a sample."""
    argv = ["--data_path", viewer["root"], "--set", "test", "--max_samples", "2", *VIEW]
    with _cwd(viewer["work"]):
        got = list(test_samples.predictions(test_samples.parse_args(argv)))
        assert len(got) == 2
        for _, data, uvd in got:
            want = viewer["apply"](viewer["variables"]["default"], data["img"],
                                   data["label_img"], data["mask"])[-1][2]
            assert uvd.shape == (1, 14, 3)
            assert _scale_gap(uvd, np.asarray(want)) <= 1e-4
        save = str(tmp_path / "samples")
        assert test_samples.main(argv + ["--headless", "--save_dir", save]) == 0
        assert sorted(os.listdir(save)) == ["sample_0.png", "sample_1.png"]


def test_check_samples_draws_augmented_samples(viewer):
    """check_samples yields the augmented crop, mask and uvd of each sample
    and its main draws them under Agg."""
    import matplotlib

    matplotlib.use("Agg")
    argv = ["--dataset", "NYU", "--data_path", viewer["root"], "--max_samples", "2",
            "--using_rotation", "--using_shift", "--device", "cpu"]
    got = list(check_samples.samples(check_samples.parse_args(argv)))
    assert len(got) == 2
    for _, s in got:
        assert s["img"].shape == (128, 128) and s["mask"].shape == (64, 64)
        assert s["uvd"].shape == (14, 3) and np.isfinite(s["uvd"]).all()
    assert check_samples.main(argv) == 0


# --------------------------------------------------------------------------- #
# bench_http against the port's server on a CPU artifact
# --------------------------------------------------------------------------- #


def test_bench_http_against_a_cpu_artifact(tmp_path, capsys):
    """2 threads x 2 requests against serve_http over a small CPU artifact:
    every request answered, the server's device calls and fill reported."""
    torch.manual_seed(0)
    state = PixelwiseRegression(21, stage=1, features=16, level=1).state_dict()
    pred = Predictor.from_state_dict(state, "MSRA", "cpu", batch_size=2, stages=1, features=16,
                                     level=1, label_size=32)
    path = str(tmp_path / "m.pwrsrv")
    export_artifact(pred, path)
    art = ServingArtifact.load(path, "cpu")
    meta = {"dataset": "MSRA", "batch_size": 2, "backend": "artifact[cpu]", "cube_default": 125.0,
            "frame_h": 240, "frame_w": 320}
    srv = make_server(art, meta, host="127.0.0.1", port=0, access_log=False, linger_s=0.002)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        out = bench_http.run(url, threads=2, requests=2, size=1)
        assert out["requests"] == 4 and out["errors"] == 0 and out["first_error"] is None
        assert 1 <= out["device_calls"] <= 4 and out["batch_fill"] >= 1.0
        assert out["frames_per_s"] > 0 and out["latency_ms"]["p99"] >= out["latency_ms"]["p50"] > 0
        assert out["target"]["backend"] == "artifact[cpu]"
        bench_http.main(["--url", url, "--threads", "1", "--requests", "1"])
        assert "throughput" in capsys.readouterr().out
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()
        server.join(timeout=30)
    assert not server.is_alive()


# --------------------------------------------------------------------------- #
# each timing tool's main on the CPU
# --------------------------------------------------------------------------- #

PROFILE = ["--batch_size", "1", "--iters", "1", *SMALL, "--device", "cpu"]
TIMED = ["--batch", "1", "--iters", "1", "--rounds", "1", "--device", "cpu"]
TOOLS = {
    "profile_train_components": PROFILE + ["--warmup", "1"],
    "profile_components": PROFILE,
    "profile_train": PROFILE + ["--warmup", "1", "--wall_steps", "1"],
    "profile_infer": PROFILE + ["--warmup", "1", "--wall_steps", "1"],
    "headconv_bwd_split": TIMED,
    "train_ab": TIMED + SMALL + ["--norms", "instance,batch"],
    "train_remat_ab": TIMED + SMALL,
    "bench_norm_variants": TIMED + SMALL,
    "bench_upsample_add": TIMED,
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_timing_tool_main_runs_on_the_cpu(tool):
    """The tool's main at a small size on the CPU returns its dict, and no
    kernel launched (CPU tensors take the plain versions)."""
    out = importlib.import_module(f"pixelwiseregression_tpu_torch.tools.{tool}").main(TOOLS[tool])
    assert isinstance(out, dict)
    if tool.startswith("profile_"):
        assert out["launches"] == {} and out["profile"].leaves
        assert not out["profile"].unattributed
    elif tool == "train_ab":
        assert set(out[1]["ms"]) == {"cuda/instance", "cuda/batch"}
    else:
        assert out["ms"] and out["launches"] == {}


def test_stage2_amplification_main_runs_on_the_cpu(generated, tmp_path):
    """One seed, two steps on an NYU fixture's crops: finite gains for each
    eps and stage, and card-vs-CPU gaps of 0 with the CPU on both sides."""
    from pixelwiseregression_tpu_torch.tools import stage2_amplification

    root = _copy(generated, tmp_path, "NYU")
    out = stage2_amplification.main(["--seeds", "1", "--steps", "2", "--data_path", root,
                                     "--device", "cpu"])
    (row,) = out["seeds"]
    assert sorted(row["gains"]) == sorted(stage2_amplification.EPS)
    for gains in row["gains"].values():
        assert len(gains["cpu"]) == 2 and all(np.isfinite(g) and g >= 0 for g in gains["cpu"])
    assert row["gap_mm"] == {"f32": [0.0, 0.0], "bf16": [0.0, 0.0]}
    assert row["loss"][1] < row["loss"][0] and out["launches"] == {}
