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

On a card, ``predict`` replays a CUDA graph of ``serving`` (``Graphed``):
each replica keeps one graph for each ``signature`` of the batch it is
given. A thread's first call of a signature runs eagerly (it warms up
cuDNN, cuBLAS and the kernels' library in that thread), its next call
captures, and every later call copies its batch into the graph's static
inputs, replays and clones the output. A static int8 Predictor stays
eager while it calibrates. A replayed request launches the same kernels
as an eager one, in one launch from the host; the kernels' launch
counters move by what the capture recorded, and ``GRAPH_CAPTURES`` and
``GRAPH_REPLAYS`` count the captures and replays.

``predict(frames, boxes=...)`` serves requests that come with a hand
detector's boxes in place of centres (HANDS 2017's test protocol): the
device finds each hand in its box and computes the crop integers from that
centre (``ops/localize.py``), batched over the request and with nothing read
back before the forward is queued; the network sees the cleaned frame. The
artifact and the HTTP server take centres only.

``fullregression=True`` serves a FullRegression checkpoint (the same
request and reply; no decoder, so no kernel: its last stage's output is
the uvd). int8 quant is refused there, as in JAX (``serve.py:104-108``).

``data_parallel=True`` serves over every visible card: one replica of the
model a card, each request batch split on axis 0 (``batch_size`` must
divide by the replicas) and gathered in order, as the JAX ``Predictor``
shards it on a ``('data',)`` mesh. Without a visible card it raises;
``devices=`` names the replicas' devices instead (the CPU tests use two
CPU replicas). ``export_artifact`` refuses a data-parallel Predictor.

Example:
    pred = Predictor.from_checkpoint("Model/NYU_default_final.pt", "NYU", "cuda:0")
    out = pred.predict(frames, coms)   # -> {"uvd": ..., "xyz": ..., "com": ...}
    out = pred.predict(frames, boxes=boxes)

``from_checkpoint`` reads the port's and the reference's ``.pt`` files and
the JAX package's msgpack ``.ckpt`` (``train/checkpoint.py``, without jax).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from pixelwiseregression_tpu_torch import obs
from pixelwiseregression_tpu_torch.core.camera import recover_uvd
from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import SPECS, DatasetSpec
from pixelwiseregression_tpu_torch.models import layers
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.layers import calibrating
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.ops import cuda_conv, cuda_softargmax
from pixelwiseregression_tpu_torch.ops.localize import box_bounds, localize
from pixelwiseregression_tpu_torch.serve_artifact import _build_batch, _device_batch
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint

# CUDA graphs of the serving function captured, and requests served by a replay
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
# the launch counters a serving forward moves: a capture launches nothing, and
# each replay adds what its capture recorded
_FORWARD_COUNTERS = ((cuda_softargmax, "LAUNCHES"), (cuda_conv, "LAUNCHES"),
                     (layers, "INT_MM_CALLS"))

# reference model_param key -> from_state_dict argument
_MODEL_PARAM_ARGS = {"stage": "stages", "features": "features", "level": "level",
                     "label_size": "label_size", "norm_method": "norm_method",
                     "heatmap_method": "heatmap_method", "kernel_size": "filter_size"}


def _build_box_batch(spec, batch_size: int, frames, boxes, cubes):
    """Raw frames + a detector's boxes -> padded host batch for
    ``ops.localize``: the frames as float32, each box's bounds
    (``box_bounds``) and cube, float64. The centre and the crop integers are
    the device's to compute."""
    n = frames.shape[0]
    if not 1 <= n <= batch_size:
        raise ValueError(f"request size {n} is not in [1, {batch_size}]")
    if len(boxes) != n:
        raise ValueError(f"{len(boxes)} boxes for {n} frames")
    cube = np.full(n, spec.cube_size) if cubes is None else np.asarray(cubes, np.float64)
    host = {"frame": np.asarray(frames, np.float32),
            "bounds": box_bounds(boxes, frames.shape[1], frames.shape[2]), "cube": cube}
    # padded rows repeat the last real one, as stack_records pads
    pad = batch_size - n
    return {k: np.ascontiguousarray(np.concatenate([v, np.repeat(v[-1:], pad, 0)]) if pad else v)
            for k, v in host.items()}, n


class ServingFunction(nn.Module):
    """The on-device serving function: a host batch of tensors
    (``_build_batch``'s fields) -> de-normalized uvd ``[B, J, 3]`` f32."""

    def __init__(self, model: nn.Module, cfg: PreprocessConfig):
        super().__init__()
        self.model = model
        self.cfg = cfg
        self.fullregression = isinstance(model, FullRegression)

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        data = preprocess_batch(batch, self.cfg, test_only=True)
        # NHWC with one channel -> NCHW. unsqueeze gives plain NCHW strides; a
        # permute would give strides that also read as channels_last, and
        # cuDNN would then run the whole network channels_last
        img, label_img, mask = (data[k][..., 0].unsqueeze(1)
                                for k in ("img", "label_img", "mask"))
        last = self.model(img, label_img, mask)[-1]
        uvd = (last if self.fullregression else last[2]).to(torch.float32)
        return recover_uvd(uvd, data["box_size"], data["com"], data["cube"])


def signature(batch: Dict[str, torch.Tensor]) -> tuple:
    """A batch's graph key: each field's name, shape and dtype."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]
    output: torch.Tensor
    launches: List[int]  # by _FORWARD_COUNTERS, what one replay launches


class Graphed:
    """A replica's serving function on a card, served by CUDA graphs: one for
    each ``signature``, captured on the signature's second call in a thread
    and replayed from then on. cuDNN's and cuBLAS's handles are made per
    thread on first use, which a capture cannot do: so until the key's
    graph exists, a thread's first call of the key runs eagerly. Calls on
    one replica take turns under its lock: each queues its batch's copy into
    the static inputs, the replay and the clone of the static output on the
    caller's stream before the next call can, so the gather of the answers
    needs no lock."""

    def __init__(self, serving: ServingFunction, device: torch.device):
        self.serving, self.device = serving, device
        self.lock = threading.Lock()
        self.thread = threading.local()  # .warm: the keys this thread ran eagerly
        self.graphs: Dict[tuple, _Graph] = {}

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        global GRAPH_REPLAYS
        key = signature(batch)
        warm = self.thread.__dict__.setdefault("warm", set())
        with self.lock:
            g = self.graphs.get(key)
            if g is None:
                if key not in warm:
                    out = self.serving(batch)
                    warm.add(key)
                    return out
                g = self.graphs[key] = self._capture(batch)
            for k, v in g.inputs.items():
                v.copy_(batch[k])
            g.graph.replay()
            out = g.output.clone()
            for (mod, attr), n in zip(_FORWARD_COUNTERS, g.launches):
                setattr(mod, attr, getattr(mod, attr) + n)
            GRAPH_REPLAYS += 1
        return out

    def _capture(self, batch: Dict[str, torch.Tensor]) -> _Graph:
        """Capture the forward on static inputs shaped as ``batch``'s, on a
        side stream, with the static inputs and output in the graph's pool.
        ``thread_local``: another thread's work meanwhile (its pageable
        copies, its localisation, its gather) does not break the capture;
        its launches would count in the capture's, which the lock keeps out
        on this replica."""
        global GRAPH_CAPTURES
        before = [getattr(mod, attr) for mod, attr in _FORWARD_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device):
            with torch.cuda.graph(graph, stream=torch.cuda.Stream(),
                                  capture_error_mode="thread_local"):
                inputs = {k: torch.empty_like(v) for k, v in batch.items()}
                output = self.serving(inputs)
        launches = []
        for (mod, attr), b in zip(_FORWARD_COUNTERS, before):
            launches.append(getattr(mod, attr) - b)
            setattr(mod, attr, b)
        GRAPH_CAPTURES += 1
        return _Graph(graph, inputs, output, launches)


def _replica_devices(devices) -> List[torch.device]:
    """The data-parallel replicas' devices: ``devices`` as given, else every
    visible card (none raises)."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError("data_parallel=True serves over the visible CUDA devices: no CUDA "
                           "device is visible (pass devices= to name the replicas' devices)")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Predictor:
    """Batched raw-frame -> joints prediction over ``replicas``
    (``[(device, ServingFunction)]``; default one, ``model`` on ``device``).
    A data-parallel Predictor passes one a device, the first holding
    ``model`` on ``device``."""

    def __init__(self, model: nn.Module, spec: DatasetSpec, cfg: PreprocessConfig,
                 batch_size: int, device: torch.device, quant_calib_batches: int = 0,
                 replicas: Optional[List] = None):
        self.model = model
        self.spec = spec
        self.cfg = cfg
        self.batch_size = batch_size
        self.device = device
        self.data_parallel = replicas is not None
        self.replicas = replicas or [(device, ServingFunction(model, cfg))]
        self.serving = self.replicas[0][1]
        # what serves each replica once no calibration is pending: on a card,
        # its CUDA graphs
        self.forwards = [Graphed(s, d) if torch.device(d).type == "cuda" else s
                         for d, s in self.replicas]
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
        fullregression: bool = False,
        data_parallel: bool = False,
        devices: Optional[Sequence] = None,
    ) -> "Predictor":
        """Build from a reference-named state dict (a port or reference
        ``.pt`` state dict, or ``compat.flax_bridge.state_dict_from_flax``'s).

        ``data_parallel=True`` places one replica on each of ``devices``
        (default: every visible card) and ignores ``device``.

        Turns TF32 off (``core.precision.tf32_off``), so that an f32 model
        runs in f32 on the card.
        """
        tf32_off()
        spec = SPECS[dataset]
        if fullregression and quant not in (None, "none"):
            raise ValueError("quant serving is PixelwiseRegression-only (FullRegression convs "
                             "carry no int8 path)")
        if data_parallel and quant is not None and "static" in quant:
            raise ValueError("data_parallel serving takes no static int8 mode: each replica "
                             "would calibrate its own scales on its own rows")
        if fullregression:
            def build():
                return FullRegression(joints=spec.joint_number, stage=stages,
                                      label_size=label_size, features=features, level=level,
                                      norm_method=norm_method, dtype=dtype)
        else:
            def build():
                return PixelwiseRegression(
                    joints=spec.joint_number, stage=stages, features=features, level=level,
                    kernel_size=filter_size, norm_method=norm_method,
                    heatmap_method=heatmap_method, decoder=decoder, dtype=dtype, quant=quant)
        # the reference's plane head also stores its constant COM filter
        state_dict = {k: v for k, v in state_dict.items() if not k.endswith(".filter")}
        cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy, halfu=spec.camera.halfu,
                               halfv=spec.camera.halfv, image_size=2 * label_size,
                               label_size=label_size)
        replicas = None
        if data_parallel:
            devs = _replica_devices(devices)
            if batch_size % len(devs):
                raise ValueError(f"batch_size {batch_size} must divide over {len(devs)} "
                                 "replicas")
            replicas = []
            for d in devs:
                m = build()
                m.load_state_dict(state_dict)
                replicas.append((d, ServingFunction(m.to(d).eval(), cfg)))
            model, device = replicas[0][1].model, devs[0]
        else:
            device = torch.device(device)
            model = build()
            model.load_state_dict(state_dict)
            model.to(device).eval()
        return cls(model, spec, cfg, batch_size, device, quant_calib_batches, replicas)

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

    def predict(self, frames: np.ndarray, coms: Optional[np.ndarray] = None,
                cubes: Optional[np.ndarray] = None,
                boxes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """Predict joints for up to ``batch_size`` raw depth frames.

        Args:
          frames: ``[N, H, W]`` raw depth in mm (dataset frame size).
          coms: ``[N, 3]`` hand centers (u, v, depth-mm).
          cubes: ``[N]`` crop cube half-sizes (dataset default if None).
          boxes: ``[N, 4]`` a detector's boxes (ustart, vstart, du, dv) in
            frame pixels, as HANDS 2017's ``BoundingBox.txt`` gives them,
            in place of ``coms``: the device finds each hand in its box
            (``ops.localize``) and the network sees the cleaned frame.

        Exactly one of ``coms`` and ``boxes`` is given. Returns ``uvd``
        ``[N, J, 3]`` (frame coords + mm) and ``xyz`` ``[N, J, 3]`` (world
        mm), both f32 numpy, and ``com`` ``[N, 3]`` float64, the centre
        used. A box with no positive depth raises ``ValueError``.

        While a profiler runs, a call records the span ``serve.predict`` and
        in it (``obs``) ``serve.build_batch`` (the host batch),
        ``serve.to_device`` (its copy to a replica), ``serve.localize`` (with
        boxes: the localisation's launches), ``serve.launch`` (the serving
        function's launches, calibration included; on a card, the copy into
        the graph's inputs, the replay and the clone) and ``serve.wait``
        (the gather of the answers to the host).
        """
        if (coms is None) == (boxes is None):
            raise ValueError("predict takes exactly one of coms and boxes")
        with obs.span("serve.predict"):
            with obs.span("serve.build_batch"):
                if boxes is None:
                    batch, count = _build_batch(self.spec, self.batch_size, frames, coms, cubes)
                else:
                    batch, count = _build_box_batch(self.spec, self.batch_size, frames, boxes,
                                                    cubes)
            # each replica runs its rows of the padded batch; every launch is
            # queued before the first result is read, so the cards overlap
            rows = self.batch_size // len(self.replicas)
            outs = []
            with torch.inference_mode():
                for i, ((d, serving), forward) in enumerate(zip(self.replicas, self.forwards)):
                    with obs.span("serve.to_device"):
                        part = _device_batch({k: v[i * rows:(i + 1) * rows]
                                              for k, v in batch.items()}, d)
                    if boxes is not None:
                        with obs.span("serve.localize"):
                            real = min(max(count - i * rows, 0), rows)
                            part, com, empty = localize(part["frame"], part["bounds"],
                                                        part["cube"], self.spec.camera, real)
                    with obs.span("serve.launch"):
                        if self.calib_left > 0:
                            with calibrating(serving.model):
                                serving(part)
                            out = serving(part)
                        else:
                            out = forward(part)
                    if boxes is not None:
                        # one gather for the answers, the centres and the flags
                        out = torch.cat([out.to(torch.float64).flatten(1), com,
                                         empty.to(torch.float64)[:, None]], dim=1)
                    outs.append(out)
                if self.calib_left > 0:
                    self.calib_left -= 1
                with obs.span("serve.wait"):
                    got = torch.cat([o.cpu() for o in outs])[:count].numpy()
            if boxes is None:
                return {"uvd": got, "xyz": self.spec.camera.uvd2xyz(got),
                        "com": np.asarray(coms, np.float64)[:, :3]}
            bad = np.flatnonzero(got[:, -1])
            if len(bad):
                raise ValueError(f"no positive depth in the box of request row {int(bad[0])}")
            uvd = got[:, :-4].astype(np.float32).reshape(count, -1, 3)
            return {"uvd": uvd, "xyz": self.spec.camera.uvd2xyz(uvd), "com": got[:, -4:-1]}
