"""PyTorch port vs the JAX package: the dataset sources, the native frame
decoders and the ``Loader``.

Each of the four synthetic fixtures (``tests/fixtures/make_*_fixture.py``)
is generated once and copied twice: the JAX sources build their index files
in one copy, the port's in the other (a source writes its index into the
dataset directory and skips the build when the files exist). Everything is
compared exactly: the index files (with the copy's root path swapped), every
record field for field, and the ``Loader``'s batches for the same seed.
"""

import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest

from pixelwiseregression_tpu.data import loader as jloader
from pixelwiseregression_tpu.data import sources as jsrc

from pixelwiseregression_tpu_torch import native as tnative
from pixelwiseregression_tpu_torch.data import loader as tloader
from pixelwiseregression_tpu_torch.data import sources as tsrc

import torch_port_threads
from torch_port_threads import one_thread  # noqa: F401 (autouse)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
DATASETS = ("MSRA", "ICVL", "NYU", "HAND17")
SPLITS = ("train", "val", "test")  # MSRA's: of held-out subject 0


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Each dataset's fixture, generated once."""
    out = {}
    for name in DATASETS:
        root = str(tmp_path_factory.mktemp(f"gen_{name.lower()}"))
        script = os.path.join(FIXTURES, f"make_{name.lower()}_fixture.py")
        subprocess.run([sys.executable, script, root], check=True, capture_output=True,
                       env=torch_port_threads.env())
        out[name] = root
    return out


def _copies(generated, tmp_path, name):
    """Two fresh copies of a fixture: (for the JAX sources, for the port's)."""
    roots = []
    for side in ("jax", "port"):
        root = str(tmp_path / f"{name.lower()}_{side}")
        shutil.copytree(generated[name], root)
        roots.append(root)
    return roots


def _kw(name):
    return {"subject": 0} if name == "MSRA" else {}


def _index_files(root):
    return sorted(f for f in os.listdir(root) if f.endswith(".txt") and (
        f.startswith(("train", "val", "test"))))


def _built(generated, tmp_path, name):
    """Both copies with every split's source built; returns the two roots and
    {split: (jax source, port source)}."""
    jroot, troot = _copies(generated, tmp_path, name)
    pairs = {}
    for split in SPLITS:
        pairs[split] = (jsrc.get_source(name, path=jroot, dataset=split, **_kw(name)),
                        tsrc.get_source(name, path=troot, dataset=split, **_kw(name)))
    return jroot, troot, pairs


def _assert_records_equal(got, want, what=""):
    assert got.keys() == want.keys(), what
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, (what, k)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")


# --------------------------------------------------------------------------- #
# the copies of the JAX module's code
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("values", [[0.1, -2.5, 1e-7, 123456.789, 3.0],
                                    [1 / 3, 2.0 ** -30, -0.0, 7.25e12, 42]])
def test_line_codec_matches(values):
    """encode_line keeps str(float) formatting; decode_line reads it back."""
    joints = np.asarray(values[:3] * 3, np.float64)
    line = tsrc.encode_line("/a/b.bin", joints)
    assert line == jsrc.encode_line("/a/b.bin", joints)
    p, d = tsrc.decode_line(line + "  \n")
    jp, jd = jsrc.decode_line(line + "  \n")
    assert p == jp == "/a/b.bin"
    np.testing.assert_array_equal(d, jd)
    assert d.dtype == np.float64 and d.shape == (3, 3)


def test_center_of_mass_fallback_matches():
    rng = np.random.RandomState(3)
    frame = rng.rand(48, 64) * 500
    frame[frame < 250] = 0
    np.testing.assert_array_equal(tsrc.center_of_mass_fallback(frame),
                                  jsrc.center_of_mass_fallback(frame))
    with pytest.raises(ValueError, match="empty frame"):
        tsrc.center_of_mass_fallback(np.zeros((4, 4)))


# --------------------------------------------------------------------------- #
# the four fixtures: index files, records, batches
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", DATASETS)
def test_index_files_match(generated, tmp_path, name):
    """The same index files, line for line (root paths swapped): MSRA's nine
    LOSO folds, ICVL's val == test, NYU's checked val, HAND17's seeded 95/5
    split."""
    jroot, troot, _ = _built(generated, tmp_path, name)
    files = _index_files(jroot)
    assert files == _index_files(troot) and files
    for f in files:
        with open(os.path.join(jroot, f)) as a, open(os.path.join(troot, f)) as b:
            want, got = a.read(), b.read()
        assert got.replace(troot, jroot) == want, f


@pytest.mark.parametrize("name", DATASETS)
def test_records_match_field_for_field(generated, tmp_path, name):
    """``record()`` of every line of every split: frames bit-exact, crop
    integers, COM, cube and joints exact, the same dtypes."""
    jroot, troot, pairs = _built(generated, tmp_path, name)
    for split, (js, ts) in pairs.items():
        assert len(ts) == len(js) > 0, split
        assert ts.joint_number == js.joint_number and ts.config == js.config
        for jl, tl in zip(js.lines, ts.lines):
            assert tl.replace(troot, jroot) == jl
            _assert_records_equal(ts.record(tl), js.record(jl), f"{split} {tl}")


def test_hand17_bb_mode_records_match(generated, tmp_path):
    """HAND17's 'bb' process mode (iterative mean-depth background removal)."""
    jroot, troot = _copies(generated, tmp_path, "HAND17")
    js = jsrc.get_source("HAND17", path=jroot, dataset="test", test_only=True, process_mode="bb")
    ts = tsrc.get_source("HAND17", path=troot, dataset="test", test_only=True, process_mode="bb")
    assert ts.lines == js.lines and ts.lines
    for line in ts.lines:
        _assert_records_equal(ts.record(line), js.record(line), line)


def test_msra_batch_records_match(generated, tmp_path):
    """MSRA's batched decode (the native library where g++ builds it, else
    the numpy path) vs the JAX source's, field for field, exactly."""
    jroot, troot, pairs = _built(generated, tmp_path, "MSRA")
    js, ts = pairs["train"]
    lines = ts.lines[:11]
    got = ts.batch_records(lines)
    want = js.batch_records([l.replace(troot, jroot) for l in lines])
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        _assert_records_equal(g, w)


def _loader_batches(loader_cls, source, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return list(loader_cls(source, **kw))


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_records_equal(g, w, f"batch {i}")


@pytest.mark.parametrize("name", DATASETS)
def test_loader_batches_match(generated, tmp_path, name):
    """The port's Loader vs the JAX Loader on the train split, shuffled with
    the same seed over two epochs, the last batch padded: every batch's
    fields, ``count`` and ``weight``, in order."""
    _, _, pairs = _built(generated, tmp_path, name)
    js, ts = pairs["train"]
    kw = dict(batch_size=5, shuffle=True, drop_last=False, num_workers=3, seed=11)
    jl, tl = jloader.Loader(js, **kw), tloader.Loader(ts, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        got, want = list(tl), list(jl)
        _assert_batches_equal(got, want)
        assert int(got[-1]["count"]) == (len(ts) - 1) % 5 + 1


def _corrupt(source, line):
    """Truncate the frame file that ``line`` names, so its decode fails."""
    path = line.split()[0]
    if isinstance(source, (jsrc.HAND17Source, tsrc.HAND17Source)):
        path = os.path.join(source.path, "training", "images", path)
    with open(path, "wb") as f:
        f.write(b"\x01\x02")


@pytest.mark.parametrize("name", ["MSRA", "NYU"])
def test_loader_skip_policy_matches(generated, tmp_path, name):
    """``on_error="skip"`` with one corrupted file in each copy: the same
    batches, with the bad row kept in place as a copy of a good record and
    flagged in the positional ``decode_ok`` mask."""
    _, _, pairs = _built(generated, tmp_path, name)
    js, ts = pairs["test"]
    bad = 2
    _corrupt(js, js.lines[bad])
    _corrupt(ts, ts.lines[bad])
    kw = dict(batch_size=3, shuffle=False, drop_last=False, num_workers=2, on_error="skip")
    got = _loader_batches(tloader.Loader, ts, **kw)
    want = _loader_batches(jloader.Loader, js, **kw)
    _assert_batches_equal(got, want)
    ok = np.concatenate([b["decode_ok"][: int(b["count"])] for b in got])
    assert ok.tolist() == [i != bad for i in range(len(ts))]


def test_loader_raise_policy_surfaces_the_decode_error(generated, tmp_path):
    _, _, pairs = _built(generated, tmp_path, "ICVL")
    _, ts = pairs["test"]
    _corrupt(ts, ts.lines[0])
    with pytest.raises(OSError):
        list(tloader.Loader(ts, batch_size=2, num_workers=2))


def test_loader_stops_its_producer_when_the_consumer_stops():
    """A consumer that stops early (break, or an exception in its loop body)
    leaves no producer thread waiting on the full queue."""
    import threading

    class Source:
        lines = [str(i) for i in range(400)]

        def record(self, line):
            return {"x": np.full(2, float(line), np.float32)}

    before = threading.active_count()
    for _ in range(5):
        it = iter(tloader.Loader(Source(), batch_size=2, num_workers=2))
        next(it)
        it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


# --------------------------------------------------------------------------- #
# native decoders: bit-exact against the numpy paths
# --------------------------------------------------------------------------- #


@pytest.fixture
def native_lib():
    if not tnative.available():
        pytest.skip("g++ could not build the native frame decoder here")
    return tnative


def test_native_builds_into_the_ports_build_dir(native_lib):
    lib = native_lib._lib_path()
    assert lib.exists() and lib.parent.name == "_build"
    assert lib.parent.parent.name == "pixelwiseregression_tpu_torch"


def test_native_msra_decode_matches_numpy(generated, tmp_path, native_lib):
    """Frames bit-exact; the COM, summed in another order, within 1e-12."""
    _, troot, pairs = _built(generated, tmp_path, "MSRA")
    _, ts = pairs["test"]
    paths = [l.split()[0] for l in ts.lines]
    frames, coms, status = native_lib.msra_decode_batch(paths, 240, 320)
    assert (status == 0).all()
    for i, p in enumerate(paths):
        tile, left, top, right, bottom = tsrc.load_bin(p)
        want = np.zeros((240, 320))
        want[top:bottom, left:right] = tile
        np.testing.assert_array_equal(frames[i], want.astype(np.float32))
        np.testing.assert_allclose(coms[i], tsrc.center_of_mass_fallback(want), rtol=1e-12)


def test_native_batch_records_match_the_numpy_records(generated, tmp_path, native_lib,
                                                      monkeypatch):
    """MSRA's batch_records through the native library vs record() on the
    numpy path: frames bit-exact, crop integers exact."""
    _, _, pairs = _built(generated, tmp_path, "MSRA")
    _, ts = pairs["val"]
    fast = ts.batch_records(ts.lines)
    monkeypatch.setattr(tnative, "available", lambda: False)
    slow = ts.batch_records(ts.lines)
    assert len(fast) == len(slow) == len(ts)
    for f, s in zip(fast, slow):
        for k in ("frame", "com_int", "crop_top", "crop_left", "box_size", "bbox", "cube",
                  "joints"):
            np.testing.assert_array_equal(f[k], s[k], err_msg=k)
        np.testing.assert_allclose(f["com"], s["com"], rtol=1e-7)


def test_native_pack_and_scale_match_numpy(native_lib):
    rng = np.random.RandomState(9)
    rgb = rng.randint(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    g = rgb[..., 1].astype(np.float32) / 255.0
    b = rgb[..., 2].astype(np.float32) / 255.0
    np.testing.assert_array_equal(native_lib.nyu_pack_batch(rgb), (g * 256.0 + b) * 255.0)
    raw = rng.randint(0, 65536, (2, 32, 32), dtype=np.uint16)
    np.testing.assert_array_equal(native_lib.png16_scale_batch(raw),
                                  (raw.astype(np.float32) / 65535.0) * 65535.0)


@pytest.mark.parametrize("name", ["ICVL", "NYU"])
def test_native_png_decode_matches_pil(generated, tmp_path, native_lib, monkeypatch, name):
    """The full native PNG decode (PWR_NATIVE_PNG=1), the native scale or
    pack after PIL (the default), and the pure numpy path give the same
    frames, bit for bit, on the fixture's frames."""
    _, troot, pairs = _built(generated, tmp_path, name)
    _, ts = pairs["test"]
    load = tsrc.load_png16 if name == "ICVL" else tsrc.load_png_nyu
    shape = (ts.spec.frame_h, ts.spec.frame_w)
    for line in ts.lines:
        path = line.split()[0]
        default = load(path, shape=shape)
        monkeypatch.setenv("PWR_NATIVE_PNG", "1")
        full = load(path, shape=shape)
        monkeypatch.delenv("PWR_NATIVE_PNG")
        with monkeypatch.context() as m:
            m.setattr(tnative, "available", lambda: False)
            plain = load(path, shape=shape)
        np.testing.assert_array_equal(full, default)
        np.testing.assert_array_equal(plain, default)
