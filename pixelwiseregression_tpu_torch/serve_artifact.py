"""Self-contained serving artifacts through ``torch.export``
(counterpart of ``pixelwiseregression_tpu/serve_artifact.py``).

``export_artifact`` freezes a ``serve.Predictor``'s whole on-device serving
function (``Predictor.serving``: preprocess -> model -> the decoder's K1
operator -> ``recover_uvd``) with its weights, norm buffers and calibrated
int8 scales into one file. ``ServingArtifact.load`` runs it with torch and
this module's host geometry alone: it imports neither the model code
(``models``) nor ``serve``, and needs no checkpoint.

The payload is a ``torch.export`` ExportedProgram, the counterpart of the
JAX package's ``jax.export`` StableHLO: a serialized graph of ATen
operators that torch runs. The decoder appears in it as the registered
operator ``torch.ops.pwr.softargmax_fwd`` (``ops/cuda_softargmax.py``), and an
f32 model's head convs as ``torch.ops.pwr.conv3x3_f32`` (``ops/cuda_conv.py``);
each dispatches by the device of its inputs when the program runs: the
kernel on the card, its plain version on the CPU. ``load(path, device)`` moves the
program to ``device`` (``torch.export.passes.move_to_device_pass``), so one
artifact serves on the card and on the CPU. A program is not compiled: the
non-kernel operators run as PyTorch's own kernels, as in the live
``Predictor``.

Host-side record precompute (the float64 crop integers, ``_build_batch``)
stays in Python here, so that loading an artifact never imports the model.

Format: ``PWRSRV1\\n`` magic, a uint32-LE header length, a JSON header
(dataset, batch size or null for a symbolic batch, frame size, joints,
batch fields, the device it was exported on, ``format: "torch.export"``,
``torch_version``), then the ``torch.export.save`` payload. The JAX
package's artifacts share the magic and carry a ``jax.export`` payload;
each loader refuses the other's by the header.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Dict, Optional

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.data.loader import stack_records
from pixelwiseregression_tpu_torch.data.sources import SPECS, load_bbox, make_record

_MAGIC = b"PWRSRV1\n"
FORMAT = "torch.export"


def _build_batch(spec, batch_size: int, frames, coms, cubes):
    """Raw frames + hand centres -> padded host batch, with the float64
    crop-integer arithmetic of the dataset sources (``make_record``),
    shared by live and exported serving."""
    n = frames.shape[0]
    if not 1 <= n <= batch_size:
        raise ValueError(f"request size {n} is not in [1, {batch_size}]")
    if cubes is None:
        cubes = np.full(n, spec.cube_size)
    records = []
    for i in range(n):
        com = np.asarray(coms[i], np.float64)
        cube = float(cubes[i])
        bbox = load_bbox(spec, com, cube) if spec.bbox_margin is not None else None
        # make_record reads only the frame's shape and its float32 values: a
        # float64 copy first would round to the same float32 numbers
        records.append(make_record(spec, frames[i], None, com, cube, bbox))
    batch, count = stack_records(records, pad_to=batch_size)
    batch.pop("weight")
    return batch, count


def _device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def export_artifact(pred, path: str, poly_batch: bool = False) -> Dict:
    """Freeze ``pred`` (a ``serve.Predictor``) into an artifact at ``path``;
    returns the header written.

    The program is traced on ``pred``'s device with the decoder it was
    built with (``decoder="cuda"``: the K1 operator; a FullRegression
    predictor has no decoder and its program calls no kernel). A
    data-parallel predictor is refused, as in JAX. A static int8
    predictor must have run its calibration batches first: its scales are
    baked in like any weight. ``poly_batch=True`` exports a symbolic batch
    dimension (``torch.export.Dim``), so a request of any size runs
    unpadded; the default fixes the batch at ``pred.batch_size`` and pads
    requests to it.
    """
    if pred.data_parallel:
        raise ValueError("export_artifact: a data_parallel Predictor is not exportable; the "
                         "artifact serves one device (run artifact replicas instead)")
    if pred.calib_left > 0:
        raise ValueError(
            f"export_artifact: static int8 predictor still has {pred.calib_left} calibration "
            "batches pending; run predict() on representative data first so that the baked "
            "scales are real")
    spec = pred.spec
    # a symbolic batch is traced from a batch of 2: a batch of 1 would
    # specialize the dimension
    pad_to = max(pred.batch_size, 2) if poly_batch else pred.batch_size
    dummy = np.zeros((1, spec.frame_h, spec.frame_w), np.float64)
    template, _ = _build_batch(spec, pad_to, dummy, np.array([[1.0, 1.0, 400.0]]), None)
    dynamic = None
    if poly_batch:
        b = torch.export.Dim("batch", min=1, max=4096)
        dynamic = ({k: {0: b} for k in template},)
    with torch.no_grad():
        ep = torch.export.export(pred.serving, (_device_batch(template, pred.device),),
                                 dynamic_shapes=dynamic)
    # the program keeps its example batch by default: a batch of raw frames
    # the artifact has no use for
    ep.example_inputs = None
    payload = io.BytesIO()
    torch.export.save(ep, payload)
    header = {
        "dataset": spec.name,
        "batch_size": None if poly_batch else pred.batch_size,
        "frame_h": spec.frame_h,
        "frame_w": spec.frame_w,
        "joint_number": spec.joint_number,
        "batch_fields": sorted(template),
        "device": str(pred.device),
        "format": FORMAT,
        "torch_version": torch.__version__,
    }
    head = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(payload.getvalue())
    return header


@dataclasses.dataclass
class ServingArtifact:
    """A loaded artifact: ``predict(frames, coms, cubes)`` as
    ``serve.Predictor``'s. Needs torch and this module's host geometry only."""

    header: Dict
    device: torch.device
    _program: object
    _spec: object

    @classmethod
    def load(cls, path: str, device=None) -> "ServingArtifact":
        """Read ``path`` and place its program on ``device`` (default: the
        device it was exported on).

        Turns TF32 off (``core.precision.tf32_off``), as ``serve.Predictor``
        does: an f32 program runs in f32 on the card (cuDNN's TF32 default
        would part from the live predictor by pixels on a deep f32 model)."""
        # registers torch.ops.pwr.softargmax_fwd and pwr.conv3x3_f32, which
        # the program calls
        from pixelwiseregression_tpu_torch.ops import cuda_conv, cuda_softargmax  # noqa: F401

        tf32_off()

        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"{path}: not a pixelwiseregression serving artifact "
                                 f"(bad magic {magic!r})")
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen))
            fmt = header.get("format") or ("jax.export (StableHLO)" if "jax_version" in header
                                           else "unknown")
            if fmt != FORMAT:
                raise ValueError(f"{path}: a {fmt} serving artifact; this loader reads "
                                 f"{FORMAT} artifacts (export one with "
                                 "pixelwiseregression_tpu_torch.tools.export_model)")
            program = torch.export.load(io.BytesIO(bytearray(f.read())))
        device = torch.device(device if device is not None else header["device"])
        if device != torch.device(header["device"]):
            program = move_to_device_pass(program, device)
        return cls(header=header, device=device, _program=program.module(),
                   _spec=SPECS[header["dataset"]])

    def predict(self, frames: np.ndarray, coms: np.ndarray,
                cubes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Same contract as ``serve.Predictor.predict`` (uvd + world xyz).

        A fixed-batch artifact pads a request to its batch size; a
        poly-batch one (header ``batch_size`` null) runs the request's size."""
        pad_to = self.header["batch_size"] or len(frames)
        batch, count = _build_batch(self._spec, pad_to, frames, coms, cubes)
        with torch.no_grad():
            uvd = self._program(_device_batch(batch, self.device))[:count].cpu().numpy()
        return {"uvd": uvd, "xyz": self._spec.camera.uvd2xyz(uvd)}
