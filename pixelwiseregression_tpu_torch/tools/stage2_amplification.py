"""How much the second stage amplifies rounding, on trained weights (the
port of the JAX package's ``tools/stage2_amplification.py``).

The JAX tool trains the reference PyTorch model and compares it with the
flax one. Here the port's own model takes the JAX tool's tiny recipe (the
reference architecture: 2 stages, 32 features, level 2, ``instance``
norms, 16x16 labels from 32x32 crops; Adam lr 1e-3 on the summed per-stage
uvd loss, ``--steps`` steps of one batch of ``--crops`` fixture crops), f32,
trained on ``--device`` with the kernel decoder (K1 forward, K2 backward),
once for each of ``--seeds`` seeds. Then, for each seed:

* the gain of the function itself: the image moved by eps in {1e-7, 1e-6,
  1e-5}, each stage's ``G = max |delta uvd| / eps`` (normalized uvd) on
  ``--device`` and on the CPU;
* the card-vs-CPU gap of each stage's uvd, in mm (u and v by the crop's
  box at the hand's depth over fx, d by the cube), in f32 and in bf16: the
  same weights and crops on both, in inference.

The crops come from ``--data_path`` (``--dataset``, ``--subject`` for
MSRA), or, without one, from an NYU fixture of 16 + 6 frames written to a
temporary directory by ``tests/fixtures/make_nyu_fixture.py``, as the JAX
tool makes them. With ``--device cpu`` both sides are the CPU (gaps 0: a
rehearsal).

Run: python -m pixelwiseregression_tpu_torch.tools.stage2_amplification
         [--seeds 3] [--steps 40] [--data_path DIR --dataset NYU] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.tools import ab_common
from pixelwiseregression_tpu_torch.train.loop import model_inputs

LABEL_SIZE = 16
EPS = (1e-7, 1e-6, 1e-5)
ARCH = dict(stage=2, features=32, level=2, kernel_size=3, norm_method="instance",
            heatmap_method="softmax", decoder="cuda")
FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "tests", "fixtures", "make_nyu_fixture.py")


def load_crops(dataset: str, root: str, n: int, subject: int = 0):
    """The first ``n`` training samples of the source, preprocessed on the
    CPU without augmentation: (the preprocess dict, the dataset spec)."""
    kw = {"subject": subject} if dataset == "MSRA" else {}
    src = get_source(dataset, path=root, dataset="train", test_only=False, **kw)
    batch = next(iter(Loader(src, batch_size=n, num_workers=2)))
    batch.pop("count")
    cam = src.spec.camera
    cfg = PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                           image_size=2 * LABEL_SIZE, label_size=LABEL_SIZE)
    return preprocess_batch(to_device(batch, "cpu"), cfg), src.spec


def mm_scale(data, spec):
    """Per sample, normalized u and v to mm (the box at the hand's depth
    over fx) and d to mm (the cube), as the JAX tool's ``mm_scale``."""
    box = data["box_size"].double().numpy()
    com = data["com"].double().numpy()
    return (box - 1) * com[:, 2] / spec.camera.fx, data["cube"].double().numpy()


def max_mm(d_uvd, uv_mm, cube):
    """max |delta| in mm over the samples and joints of ``[N, J, 3]``."""
    mm = np.abs(d_uvd) * np.stack([uv_mm, uv_mm, cube], axis=1)[:, None, :]
    return float(mm.max())


def train(data, joints, seed, steps, device):
    """The JAX tool's recipe on ``device``: returns the trained state dict
    (on the CPU) and the loss before and after."""
    torch.manual_seed(seed)
    model = PixelwiseRegression(joints, **ARCH).to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    inputs = [t.to(device) for t in model_inputs(data)]
    uvd_t = data["uvd"].to(device)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = sum(((uvd - uvd_t) ** 2).sum(-1).mean() for _, _, uvd in model(*inputs))
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    return {k: v.cpu() for k, v in model.state_dict().items()}, losses[0], losses[-1]


def uvds(state, joints, data, device, dtype, image=None):
    """Each stage's uvd ``[N, J, 3]`` (f64 numpy) of the trained weights in
    inference on ``device`` at ``dtype``, on ``image`` (default the crops')."""
    model = PixelwiseRegression(joints, **ARCH, dtype=dtype)
    model.load_state_dict(state)
    model.to(device).eval()
    img, label, mask = model_inputs(data)
    img = img if image is None else image
    with torch.no_grad():
        out = model(img.to(device), label.to(device), mask.to(device))
    return [r[2].double().cpu().numpy() for r in out]


def measure(args) -> dict:
    device = ab_common.pick_device(args.device)
    cpu = torch.device("cpu")
    with tempfile.TemporaryDirectory(prefix="pwr_amp_") as tmp:
        root = args.data_path
        if root is None:
            root = os.path.join(tmp, "nyu")
            subprocess.run([sys.executable, FIXTURE, root, "16", "6"], check=True,
                           capture_output=True)
        data, spec = load_crops(args.dataset, root, args.crops, args.subject)
    joints = spec.joint_number
    uv_mm, cube = mm_scale(data, spec)
    img = model_inputs(data)[0]
    before = ab_common.read_counts()
    seeds = []
    for seed in range(args.seeds):
        state, first, last = train(data, joints, seed, args.steps, device)
        row = {"seed": seed, "loss": (first, last), "gains": {}, "gap_mm": {}}
        base = {d: uvds(state, joints, data, d, torch.float32) for d in (device, cpu)}
        for eps in EPS:
            row["gains"][eps] = {
                d.type: [float(np.abs(p - b).max()) / eps for b, p in zip(
                    base[d], uvds(state, joints, data, d, torch.float32, img + eps))]
                for d in (device, cpu)}
        row["gap_mm"]["f32"] = [max_mm(a - b, uv_mm, cube)
                                for a, b in zip(base[device], base[cpu])]
        bf16 = [uvds(state, joints, data, d, torch.bfloat16) for d in (device, cpu)]
        row["gap_mm"]["bf16"] = [max_mm(a - b, uv_mm, cube) for a, b in zip(*bf16)]
        seeds.append(row)
    after = ab_common.read_counts()
    return {"device": str(device), "seeds": seeds,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--crops", type=int, default=8, help="training crops (one batch)")
    ap.add_argument("--dataset", type=str, default="NYU")
    ap.add_argument("--data_path", type=str, default=None,
                    help="a dataset root (default: an NYU fixture in a temporary directory)")
    ap.add_argument("--subject", type=int, default=0, help="MSRA's held-out subject")
    args = ab_common.device_arg(ap).parse_args(argv)
    out = measure(args)
    dev = torch.device(out["device"]).type
    for row in out["seeds"]:
        print(f"--- seed {row['seed']} --- trained {args.steps} steps on {out['device']}: loss "
              f"{row['loss'][0]:.4f} -> {row['loss'][1]:.4f}", flush=True)
        for eps, gains in row["gains"].items():
            print(f"  eps={eps:.0e} " + "  ".join(
                f"{d}: stage gains " + " ".join(f"{g:9.1f}" for g in gains[d])
                for d in dict.fromkeys((dev, "cpu"))), flush=True)
        for dtype, mms in row["gap_mm"].items():
            print(f"  {dev} vs cpu ({dtype}): " + " ".join(
                f"stage{i + 1} {m:8.4f} mm" for i, m in enumerate(mms)), flush=True)
    print(f"launches {out['launches']}", flush=True)
    return out


if __name__ == "__main__":
    main()
