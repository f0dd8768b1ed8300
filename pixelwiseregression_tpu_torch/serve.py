"""Serving API: persistent-weights batched prediction
(mirrors ``pixelwiseregression_tpu/serve.py``).

A ``Predictor`` holds the model's weights on its device and serves batches
of raw depth frames end to end: host crop integers -> on-device crop and
resize -> model -> soft-argmax decode (K1 on the card) -> de-normalized
uvd and world xyz. Requests are padded to ``batch_size`` and only the real
rows come back. Its defaults are the JAX ``Predictor.from_checkpoint``'s:
the two-pass ``instance`` norm and f32 activations; the decoder is K1
(``decoder="cuda"``: its plain version on the CPU), the counterpart of both
JAX decoders.

``quant="int8[_static][_all|_heads]"`` serves the int8 model
(``models/layers.py``); a static mode calibrates its scales on the first
``quant_calib_batches`` ``predict`` calls and then freezes them, as the JAX
``Predictor`` does.

``serving`` is the whole on-device function (preprocess -> model -> K1 ->
``recover_uvd``) as one module: ``predict`` runs it, and
``serve_artifact.export_artifact`` exports it, so the artifact computes
what the live ``Predictor`` computes.

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
from torch import nn

from pixelwiseregression_tpu_torch.core.camera import recover_uvd
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import SPECS, DatasetSpec
from pixelwiseregression_tpu_torch.models.layers import calibrating
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.serve_artifact import _build_batch, _device_batch
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint

# reference model_param key -> from_state_dict argument
_MODEL_PARAM_ARGS = {"stage": "stages", "features": "features", "level": "level",
                     "label_size": "label_size", "norm_method": "norm_method",
                     "heatmap_method": "heatmap_method", "kernel_size": "filter_size"}


class ServingFunction(nn.Module):
    """The on-device serving function: a host batch of tensors
    (``_build_batch``'s fields) -> de-normalized uvd ``[B, J, 3]`` f32."""

    def __init__(self, model: PixelwiseRegression, cfg: PreprocessConfig):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        data = preprocess_batch(batch, self.cfg, test_only=True)
        # NHWC with one channel -> NCHW. unsqueeze gives plain NCHW strides; a
        # permute would give strides that also read as channels_last, and
        # cuDNN would then run the whole network channels_last
        img, label_img, mask = (data[k][..., 0].unsqueeze(1)
                                for k in ("img", "label_img", "mask"))
        uvd = self.model(img, label_img, mask)[-1][2].to(torch.float32)
        return recover_uvd(uvd, data["box_size"], data["com"], data["cube"])


class Predictor:
    """Batched raw-frame -> joints prediction on one device."""

    def __init__(self, model: PixelwiseRegression, spec: DatasetSpec, cfg: PreprocessConfig,
                 batch_size: int, device: torch.device, quant_calib_batches: int = 0):
        self.model = model
        self.spec = spec
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device
        self.serving = ServingFunction(model, cfg)
        static = model.quant is not None and "static" in model.quant
        # predict() calls left that calibrate the static int8 scales
        self.calib_left = quant_calib_batches if static else 0

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
        norm_method: str = "instance",
        heatmap_method: str = "softmax",
        filter_size: int = 3,
        decoder: str = "cuda",
        dtype: torch.dtype = torch.float32,
        quant: Optional[str] = None,
        quant_calib_batches: int = 4,
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
            decoder=decoder, dtype=dtype, quant=quant)
        # the reference's plane head also stores its constant COM filter
        model.load_state_dict({k: v for k, v in state_dict.items() if not k.endswith(".filter")})
        model.to(device).eval()
        cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                               halfv=spec.camera.halfv, image_size=2 * label_size,
                               label_size=label_size)
        return cls(model, spec, cfg, batch_size, device, quant_calib_batches)

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
        batch = _device_batch(batch, self.device)
        with torch.inference_mode():
            if self.calib_left > 0:
                with calibrating(self.model):
                    self.serving(batch)
                self.calib_left -= 1
            uvd = self.serving(batch)[:count].cpu().numpy()
        return {"uvd": uvd, "xyz": self.spec.camera.uvd2xyz(uvd)}
