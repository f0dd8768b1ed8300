"""Inference entry point shared by ``cli/test.py``, ``cli/test_msra.py`` and
``cli/test_fullregression.py`` (mirrors ``pixelwiseregression_tpu/cli/test_main.py``).

Runs the test split through the on-device preprocessing and the model (K1
under ``--decoder cuda``), de-normalizes uvd with ``recover_uvd`` on the
device, and writes ``Result/<dataset>_<suffix>.txt`` in the reference's
format (HAND17: xyz and the challenge's submission rows). Prints frames/s.
Reads a port ``.pt``, a reference ``.pt`` or a JAX ``.ckpt``.

``--quant`` runs the int8 model; a static mode first calibrates its scales
on the first ``--quant_calib_batches`` test batches and refuses to run on
none or on all-zero scales. ``fullregression=True`` runs a FullRegression
checkpoint, whose last stage's output is the uvd (JAX ``:93``).
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from pixelwiseregression_tpu_torch.cli.common import (
    model_kwargs_from_args,
    resolve_device,
    resolve_num_workers,
)
from pixelwiseregression_tpu_torch.core.camera import recover_uvd
from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.layers import quant_scales
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint
from pixelwiseregression_tpu_torch.train.loop import model_inputs


def _find_model_file(model_dir: str, base: str) -> str:
    """Prefer the port's .pt; fall back to a JAX .ckpt."""
    for ext in (".pt", ".ckpt"):
        p = os.path.join(model_dir, base + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"no checkpoint {base}(.pt|.ckpt) under {model_dir}")


def run_inference(args, dataset_name: str, fullregression: bool = False, subject=None):
    """Write the test split's predictions; returns ``(result file, frames/s)``."""
    device = resolve_device(args)
    os.makedirs("Result", exist_ok=True)
    if not os.path.exists("Model"):
        raise FileNotFoundError("Please put the models in ./Model folder")

    source_kw = dict(path=args.data_path, test_only=True)
    if subject is not None:
        source_kw["subject"] = subject
    process_mode = getattr(args, "process_mode", "uvd")
    if process_mode != "uvd":
        source_kw["process_mode"] = process_mode
    testset = get_source(dataset_name, dataset="test", **source_kw)
    joints = testset.joint_number
    model_kw = model_kwargs_from_args(args, joints, fullregression=fullregression)
    cam = testset.spec.camera
    pp = PreprocessConfig(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv,
                          image_size=args.label_size * 2, label_size=args.label_size,
                          kernel_size=args.kernel_size, sigma=args.sigmoid)

    suffix = args.suffix
    if subject is not None:
        suffix = f"{args.suffix}_subject{subject}"
    ckpt_path = _find_model_file("Model", f"{dataset_name}_{suffix}_{args.seed}")
    # an f32 model runs in f32 on the card, as in serve.Predictor
    tf32_off()
    model = (FullRegression if fullregression else PixelwiseRegression)(**model_kw)
    model.load_state_dict(load_checkpoint(ckpt_path)["state_dict"])
    model.to(device).eval()

    def infer(batch):
        with torch.inference_mode():
            data = preprocess_batch(to_device(batch, device), pp, test_only=True)
            last = model(*model_inputs(data))[-1]
            uvd = (last if fullregression else last[2]).to(torch.float32)
            return recover_uvd(uvd, data["box_size"], data["com"], data["cube"]).cpu().numpy()

    loader = Loader(testset, args.batch_size, shuffle=False, drop_last=False,
                    num_workers=resolve_num_workers(args.num_workers),
                    on_error="skip" if getattr(args, "skip_bad_samples", False) else "raise")

    quant = model_kw.get("quant")
    if quant and "static" in quant:
        # calibrate the static int8 scales (running per-channel |x| max) on
        # the first --quant_calib_batches batches, then freeze them
        n_ran = 0
        for batch in itertools.islice(loader, args.quant_calib_batches):
            batch.pop("count")
            batch.pop("decode_ok", None)
            with torch.inference_mode():
                data = preprocess_batch(to_device(batch, device), pp, test_only=True)
                model.calibrate(*model_inputs(data))
            n_ran += 1
        # zero calibration batches would leave the scales at 0: every
        # activation would saturate to +-127, silently
        if n_ran == 0:
            raise RuntimeError("int8 static quantization needs >= 1 calibration batch but none "
                               "ran (--quant_calib_batches=0 or an empty dataset); refusing to "
                               "run inference with uncalibrated scales")
        if not all(float(s.max()) > 0 for s in quant_scales(model).values()):
            raise RuntimeError("int8 static calibration produced zero scales: check the "
                               "calibration data")

    print("running on test dataset ......")
    pre_uvd = []
    start = time.time()
    n = 0
    for batch in loader:
        count = int(batch.pop("count"))
        # rows are positional (matched to the test list / HAND17 image names
        # by index), so undecodable samples keep their row as NaN instead of
        # shifting every following prediction onto the wrong frame
        decode_ok = np.asarray(batch.pop("decode_ok", np.ones(count, bool)))[:count]
        out = infer(batch)[:count]
        if dataset_name == "HAND17":
            out = cam.uvd2xyz(out)
        out = out.astype(np.float64)
        out[~decode_ok] = np.nan
        pre_uvd.append(out.reshape(-1, joints * 3))
        n += count
    elapsed = time.time() - start
    print(f"test code runs on {n / elapsed:.2f} FPS")

    pre_uvd = np.concatenate(pre_uvd, axis=0)
    if args.seed == "final":
        result_name = f"Result/{dataset_name}_{suffix}.txt"
    else:
        result_name = f"Result/{dataset_name}_{suffix}_{args.seed}.txt"
    np.savetxt(result_name, pre_uvd, fmt="%.3f")

    if dataset_name == "HAND17":
        # challenge submission format (reference: test.py:126-137)
        with open(result_name) as f:
            rows = f.readlines()
        out_rows = ["\t".join(["frame\\images\\image_D%08d.png" % (i + 1)] + r.split())
                    for i, r in enumerate(rows)]
        with open(result_name, "w") as f:
            f.write("\n".join(out_rows))

    return result_name, n / elapsed
