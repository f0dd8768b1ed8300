"""Serving API: persistent-weights batched prediction
(mirrors ``pixelwiseregression_tpu/serve.py``).

A ``Predictor`` holds the model's weights on its device and serves batches
of raw depth frames end to end: host crop integers -> on-device crop and
resize -> model -> soft-argmax decode -> de-normalized uvd and world xyz.
Requests are padded to ``batch_size`` and only the real rows come back.

Example:
    pred = Predictor.from_checkpoint("Model/NYU_default_final.pt", "NYU", "cuda:0")
    out = pred.predict(frames, coms)   # -> {"uvd": ..., "xyz": ...}

``from_checkpoint`` reads the port's and the reference's ``.pt`` files and
the JAX package's msgpack ``.ckpt`` (``train/checkpoint.py``, without jax).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from pixelwiseregression_tpu_torch.core.camera import recover_uvd
from pixelwiseregression_tpu_torch.data.loader import stack_records
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import SPECS, DatasetSpec, load_bbox, make_record
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint

# reference model_param key -> from_state_dict argument
_MODEL_PARAM_ARGS = {"stage": "stages", "features": "features", "level": "level",
                     "label_size": "label_size", "norm_method": "norm_method",
                     "heatmap_method": "heatmap_method", "kernel_size": "filter_size"}


def _build_batch(spec: DatasetSpec, batch_size: int, frames, coms, cubes):
    """Raw frames + hand centres -> padded host batch, with the float64
    crop-integer arithmetic of the dataset sources."""
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
        records.append(make_record(spec, frames[i].astype(np.float64), None, com, cube, bbox))
    batch, count = stack_records(records, pad_to=batch_size)
    batch.pop("weight")
    return batch, count


class Predictor:
    """Batched raw-frame -> joints prediction on one device."""

    def __init__(self, model: PixelwiseRegression, spec: DatasetSpec, cfg: PreprocessConfig,
                 batch_size: int, device: torch.device):
        self.model = model
        self.spec = spec
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device

    @classmethod
    def from_state_dict(
        cls,
        state_dict: Mapping[str, torch.Tensor],
        dataset: str,
        device,
        batch_size: int = 32,
        stages: int = 2,
        features: int = 128,
        level: int = 4,
        label_size: int = 64,
        norm_method: str = "instance_anchored",
        heatmap_method: str = "softmax",
        filter_size: int = 3,
        decoder: str = "cuda",
        dtype: torch.dtype = torch.bfloat16,
    ) -> "Predictor":
        """Build from a reference-named state dict (a port or reference
        ``.pt`` state dict, or ``compat.flax_bridge.state_dict_from_flax``'s).

        Sets ``torch.backends.cudnn.allow_tf32`` and
        ``torch.backends.cuda.matmul.allow_tf32`` to False, so that an f32
        model runs in f32 on the card.
        """
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device(device)
        spec = SPECS[dataset]
        model = PixelwiseRegression(
            joints=spec.joint_number, stage=stages, features=features, level=level,
            kernel_size=filter_size, norm_method=norm_method, heatmap_method=heatmap_method,
            decoder=decoder, dtype=dtype)
        # the reference's plane head also stores its constant COM filter
        model.load_state_dict({k: v for k, v in state_dict.items() if not k.endswith(".filter")})
        model.to(device).eval()
        cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                               halfv=spec.camera.halfv, image_size=2 * label_size,
                               label_size=label_size)
        return cls(model, spec, cfg, batch_size, device)

    @classmethod
    def from_checkpoint(cls, path: str, dataset: str, device, **kwargs) -> "Predictor":
        """Load a checkpoint (``train.checkpoint.load_checkpoint``): a
        ``torch.save``d ``{"state_dict", "model_param", ...}`` file, the
        reference's format, which the port's train CLI writes, or a JAX
        ``.ckpt``. The architecture stored in ``model_param`` overrides
        ``kwargs``."""
        ckpt = load_checkpoint(path)
        for key, arg in _MODEL_PARAM_ARGS.items():
            if key in (ckpt.get("model_param") or {}):
                kwargs[arg] = ckpt["model_param"][key]
        return cls.from_state_dict(ckpt["state_dict"], dataset, device, **kwargs)

    def predict(self, frames: np.ndarray, coms: np.ndarray,
                cubes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Predict joints for up to ``batch_size`` raw depth frames.

        Args:
          frames: ``[N, H, W]`` raw depth in mm (dataset frame size).
          coms: ``[N, 3]`` hand centers (u, v, depth-mm).
          cubes: ``[N]`` crop cube half-sizes (dataset default if None).

        Returns ``uvd`` ``[N, J, 3]`` (frame coords + mm) and ``xyz``
        ``[N, J, 3]`` (world mm), both f32 numpy.
        """
        batch, count = _build_batch(self.spec, self.batch_size, frames, coms, cubes)
        with torch.inference_mode():
            data = preprocess_batch(
                {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()},
                self.cfg, test_only=True)
            # NHWC with one channel -> NCHW. unsqueeze gives plain NCHW strides; a
            # permute would give strides that also read as channels_last, and
            # cuDNN would then run the whole network channels_last
            img, label_img, mask = (data[k][..., 0].unsqueeze(1)
                                    for k in ("img", "label_img", "mask"))
            uvd = self.model(img, label_img, mask)[-1][2].to(torch.float32)
            uvd = recover_uvd(uvd, data["box_size"], data["com"], data["cube"])
            uvd = uvd[:count].cpu().numpy()
        return {"uvd": uvd, "xyz": self.spec.camera.uvd2xyz(uvd)}
