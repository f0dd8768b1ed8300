"""V2V-PoseNet on the port (``models/v2v.py``, ``ops/voxel.py``,
``train/loop.make_train_step_v2v``) against the benchmark's plain reference
(``port_bench/reference/v2v.py``) on the CPU: the published widths on a
small grid (an input side of 24, which halves to 12, 6 and 3) at batch 2.
The grids at the published side of 88 too, bit for bit. V2V-PoseNet has no
counterpart in the JAX package."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from port_bench import synth
from port_bench.drivers import train_v2v as drv
from port_bench.reference import v2v as ref

from pixelwiseregression_tpu_torch.core.camera import Camera
from pixelwiseregression_tpu_torch.models.v2v import V2VPoseNet
from pixelwiseregression_tpu_torch.ops import voxel
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.train import loop

from torch_port_threads import env, one_thread  # noqa: F401 (autouse)

NYU = dict(fx=588.037, fy=587.075, halfu=320.0, halfv=240.0)
SIDE = 24
SEED = 2**31 + 125
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "make_nyu_fixture.py")


def _cfg(side=SIDE):
    return voxel.VoxelConfig(**NYU, side=side)


def _ref_cfg(side=SIDE):
    """The benchmark configuration's layout, as the reference reads it."""
    return {"dataset": {"camera": NYU},
            "voxel": {"cube": 250.0, "side": side, "sigma": 1.7},
            "model": {"in_size": side, "out_size": side // 2},
            "optimizer": {"lr": 2.5e-4, "alpha": 0.99, "eps": 1e-8}}


def _batch(b=2, seed=SEED):
    raw = synth.raw_batch(b, 480, 640, 14, fx=NYU["fx"], fy=NYU["fy"], cube=250.0, seed=seed)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def _draws(b, augment, seed=SEED):
    if not augment:
        return voxel.no_augmentation(b, "cpu")
    cfg = {"voxel": {"rotation": 40.0, "scale": [0.8, 1.2], "shift": 8.0}}
    return drv.draws(1, b, cfg, seed, torch.device("cpu"))[0]


def _net(seed=SEED):
    net = V2VPoseNet(14, SIDE)
    net.load_state_dict(drv.weights(net, seed, torch.device("cpu")), strict=True)
    return net


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("side", [SIDE, 88])
def test_the_voxeliser_equals_the_reference(augment, side):
    batch, d = _batch(), _draws(2, augment)
    coef = voxel.coefficients(batch["com"], d, _cfg(side))
    grid = voxel.voxelize(batch["frame"], coef, side)
    c = ref.sample_numbers(batch["com"], d, {**NYU, "cube": 250.0, "side": side})
    assert torch.equal(grid, ref.grids(batch["frame"], c, side))
    assert grid.shape == (2, 1, side, side, side) and int(grid.sum()) > 100
    got = voxel.targets(batch["joints"], coef, side // 2, 1.7).reshape(2, 14, *[side // 2] * 3)
    torch.testing.assert_close(got, ref.targets(batch["joints"], c, side // 2, 1.7),
                               rtol=0, atol=2e-6)
    assert float(got.amax()) > 0.5


def test_the_cube_edge_and_an_empty_frame_as_the_reference():
    """Pixels at the centre's depth plus and minus half the cube, on either
    side of each face, and a frame with no positive depth."""
    b, h, w = 2, 8, 16
    frame = torch.zeros(b, h, w)
    com = torch.tensor([[8.0, 4.0, 600.0], [8.0, 4.0, 600.0]])
    vox_mm = 250.0 / SIDE
    for i, dz in enumerate((-125.0, 125.0, -125.0 + 1e-3, 125.0 - 1e-3, 0.0, vox_mm / 2)):
        frame[0, i, :] = 600.0 + dz
    frame[0, 7, 3:5] = -5.0
    d = voxel.no_augmentation(b, "cpu")
    coef = voxel.coefficients(com, d, _cfg())
    grid = voxel.voxelize(frame, coef, SIDE)
    want = ref.grids(frame, ref.sample_numbers(com, d, {**NYU, "cube": 250.0, "side": SIDE}),
                     SIDE)
    assert torch.equal(grid, want)
    assert 0 < int(grid[0].sum()) and int(grid[1].sum()) == 0


def test_the_forward_equals_the_reference():
    net = _net().train()
    grid = (torch.rand(2, 1, SIDE, SIDE, SIDE, generator=torch.Generator().manual_seed(1)) < 0.05
            ).float()
    sd = net.state_dict()
    p = {k: v.clone() for k, v in sd.items()}
    s = {k: v.clone() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}
    out = net(grid)
    assert out.shape == (2, 14, SIDE // 2, SIDE // 2, SIDE // 2)
    torch.testing.assert_close(out, ref.forward(p, s, grid), rtol=1e-5, atol=1e-8)
    # the running statistics moved alike
    for k, v in s.items():
        torch.testing.assert_close(net.state_dict()[k], v, rtol=1e-5, atol=1e-9)
    assert sum(x.numel() for x in V2VPoseNet(14).parameters()) == 3_410_222


def test_one_rmsprop_step_equals_the_reference():
    net = _net()
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    batch, d = _batch(), _draws(2, True)
    state = loop.create_train_state(net, opt="rmsprop", lr=2.5e-4, lr_decay=1.0)
    out = loop.make_train_step_v2v(_cfg())(state, batch, draws=d)
    r = ref.train_steps(_ref_cfg(), weights, [batch], [d], rows=2)
    assert float(out["loss"]) == pytest.approx(r["losses"][0], rel=1e-6)
    assert out["stage_losses"].shape == (1, 3)
    # a conv's bias under a BatchNorm (all but the output layer's) has a
    # gradient of nought but rounding, and is not compared
    under_bn = {f"{name}.bias" for name, m in net.named_modules()
                if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d))
                and name != "output_layer"}
    moved = [k for k, _ in net.named_parameters() if k not in under_bn]
    assert "front_layers.0.block.1.bias" in moved and "front_layers.0.block.0.bias" not in moved
    for k, p in net.named_parameters():
        if k in moved:
            grad = float(torch.linalg.vector_norm(p.grad))
            assert grad == pytest.approx(r["grad_norms"][k], rel=1e-4), k
            change = float(torch.linalg.vector_norm(p.detach() - weights[k]))
            assert change == pytest.approx(r["change_norms"][k], rel=1e-3), k


def test_make_optimizer_rmsprop():
    w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    opt, sched = loop.make_optimizer([w], "rmsprop", lr=0.1)
    assert isinstance(opt, torch.optim.RMSprop)
    g = opt.param_groups[0]
    assert (g["alpha"], g["eps"], g["momentum"], g["weight_decay"]) == (0.99, 1e-8, 0.0, 0.0)
    w.grad = torch.tensor([0.5, -1.0, 0.0])
    opt.step()
    sched.step()
    sq = 0.01 * torch.tensor([0.25, 1.0, 0.0])
    want = torch.tensor([1.0, -2.0, 3.0]) - 0.1 * torch.tensor([0.5, -1.0, 0.0]) / (sq.sqrt()
                                                                                 + 1e-8)
    torch.testing.assert_close(w.detach(), want)


def test_the_new_counters_are_registered():
    assert ab_common.COUNTERS["voxelize"] == (voxel, "LAUNCHES")
    assert ab_common.COUNTERS["voxelized"] == (voxel, "VOXELIZED")
    # the plain version launches nothing
    before = ab_common.read_counts()
    batch = _batch(1)
    voxel.voxelize(batch["frame"], voxel.coefficients(batch["com"], _draws(1, False), _cfg()),
                   SIDE)
    assert ab_common.read_counts() == before


def test_the_argmax_decode_finds_each_joint():
    """Heatmaps that are the targets decode to each joint's world point
    within half an output voxel an axis; the eval step's error is finite."""
    batch, d = _batch(), _draws(2, True)
    cfg = _cfg(88)
    coef = voxel.coefficients(batch["com"], d, cfg)
    hm = voxel.targets(batch["joints"], coef, 44, 1.7)
    xyz = loop.decode_v2v(hm, coef)
    true = Camera(**NYU).uvd2xyz(batch["joints"])
    edge = 2 * 250.0 / 88 / 0.8  # an output voxel in mm at the smallest scale
    assert float((xyz - true).abs().max()) <= edge / 2 + 1e-3


def test_the_v2v_cli_trains_on_the_nyu_fixture(tmp_path, monkeypatch, capsys):
    """``cli/train_v2v.py`` on the NYU fixture after ``check_dataset``: two
    train steps of 6 at a side of 24, the argmax decode's val error, a
    checkpoint."""
    from pixelwiseregression_tpu_torch.cli import check_dataset, train_v2v
    from pixelwiseregression_tpu_torch.cli.train_main import run_training
    root = str(tmp_path / "nyu")
    subprocess.run([sys.executable, FIXTURE, root, "12", "4"], check=True, capture_output=True,
                   env=env())
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PWR_TB_IMAGES", "0")
    check_dataset.main(["--dataset", "NYU", "--data_path", root, "--device", "cpu"])
    args = train_v2v.make_parser().parse_args(
        ["--dataset", "NYU", "--data_path", root, "--device", "cpu", "--epoch", "1",
         "--batch_size", "6", "--in_size", str(SIDE), "--num_workers", "2", "--seed", "5"])
    assert (args.opt, args.lr, args.lr_decay) == ("rmsprop", 2.5e-4, 1.0)
    run_training(args, "NYU", family="v2v")
    out = capsys.readouterr().out
    m = re.search(r"epoch 0: train_loss ([0-9.e+-]+)\s+val mean-mm \[\s*([0-9.e+-]+)\]", out)
    assert m and np.isfinite(float(m.group(1))) and 0 < float(m.group(2)) < 1e3, out
    ckpt = torch.load(tmp_path / "Model" / "NYU_v2v_0.pt", weights_only=True)
    assert ckpt["step"] == 2 and ckpt["model_param"]["family"] == "v2v"
    assert isinstance(ckpt["optimizer"]["state"][0]["square_avg"], torch.Tensor)
    assert os.path.exists(tmp_path / "Model" / "NYU_v2v_final.pt")
