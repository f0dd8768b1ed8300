"""Training and eval steps: loss, optimizer, schedule, step factories
(mirrors ``pixelwiseregression_tpu/train/loop.py``).

The loss is the reference's, per stage:

  L_h = lambda_h * mean_{B,J} sum_{HW} (hm - hm*)^2
  L_d = lambda_d * mean_{B,J} sum_{HW} (dm - dm*)^2
  L_u = mean_{B,J} sum_3 (uvd - uvd*)^2
  total = sum over stages of alpha * L_u + (1 - alpha) * (L_h + L_d)

(the default alpha=1 zeroes the auxiliary losses: a reference quirk kept
for parity). Samples that are invalid (a failed augmentation) or padding
(``weight`` 0) are masked out, and the mean divides by the number of the
others. AdamW or SGD with the reference's StepLR, applied per step: the
step-``i`` update uses ``lr * lr_decay ** ((i // steps_per_epoch) //
decay_epoch)``, as optax evaluates its schedule before the update.

A step takes a raw batch already on the device (frames + crop integers,
as ``utils/synth.py`` and the host records give them), runs the on-device
preprocessing without autograd, then forward, backward and the optimizer
step. Built with ``preprocess_cfg=None``, the train and eval steps take a
batch that is already preprocessed instead, in ``preprocess_batch``'s
layout. The eval step computes the mean 3-D joint error on the device and
returns only small tensors. ``make_train_step_fullreg`` and
``make_eval_step_fullreg`` are the FullRegression family's (the JAX
package's ``cli/train_main.py:354-435``): the uvd loss alone.
``make_train_step_v2v`` and ``make_eval_step_v2v`` are V2V-PoseNet's
(``models/v2v.py``, no JAX counterpart): the raw frames voxelised on the
device (``ops/voxel.py``), the mean squared error to the joints' 3D
Gaussians, RMSprop.

In a ``torch.distributed`` run (``parallel/mesh.py``) each rank passes its
slice of the global batch, and every step computes what the JAX step
computes over the global batch on a mesh: the denominators count the
global batch's valid samples, the norms take global statistics, the
augmentation draws are the global batch's (from a generator seeded alike
on every rank) sliced to the rank, the gradients are summed over the ranks
before the optimizer step, and the metrics returned are the global ones.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from pixelwiseregression_tpu_torch import obs
from pixelwiseregression_tpu_torch.core.camera import Camera, recover_uvd
from pixelwiseregression_tpu_torch.core.precision import tf32_off
from pixelwiseregression_tpu_torch.data.preprocess import (
    PreprocessConfig,
    draw_augmentation,
    preprocess_batch,
)
from pixelwiseregression_tpu_torch.ops import voxel
from pixelwiseregression_tpu_torch.parallel import mesh


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_h: float = 1.0
    lambda_d: float = 0.01
    alpha: float = 1.0


@dataclasses.dataclass
class TrainState:
    """The model (its params and its norms' running statistics), the
    optimizer, the per-step schedule and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def make_optimizer(params, opt: str = "adam", lr: float = 1e-3, beta1: float = 0.9,
                   beta2: float = 0.999, weight_decay: float = 0.0, lr_decay: float = 0.2,
                   decay_epoch: float = 15, steps_per_epoch: int = 1):
    """AdamW / SGD / RMSprop with the reference's StepLR as a per-step
    ``LambdaLR``; returns ``(optimizer, scheduler)``. Call
    ``scheduler.step()`` after each ``optimizer.step()``.

    ``weight_decay`` is passed explicitly: ``torch.optim.AdamW`` would
    default to 0.01, the JAX package to 0. SGD has momentum ``beta1`` and
    adds ``weight_decay * param`` to the gradient before it, as the JAX
    package's ``add_decayed_weights`` chain does. RMSprop (V2V-PoseNet's)
    takes alpha 0.99, eps 1e-8 and no momentum, torch's defaults, which the
    V2V-PoseNet reimplementation takes; ``beta1`` and ``beta2`` are not read.
    """
    params = list(params)
    if opt == "adam":
        optimizer = torch.optim.AdamW(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                                      weight_decay=weight_decay)
    elif opt == "sgd":
        optimizer = torch.optim.SGD(params, lr=lr, momentum=beta1, weight_decay=weight_decay)
    elif opt == "rmsprop":
        optimizer = torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                                        weight_decay=weight_decay, momentum=0.0)
    else:
        raise ValueError(f"unknown optimizer {opt}")

    def factor(step: int) -> float:
        return lr_decay ** ((step // steps_per_epoch) // decay_epoch)

    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, factor)


def create_train_state(model: nn.Module, **optimizer_kwargs) -> TrainState:
    """A fresh state around ``model`` (``make_optimizer``'s keyword arguments).

    Turns TF32 off (``core.precision.tf32_off``), as ``Predictor`` does, so
    that an f32 model trains in f32 on the card.
    """
    tf32_off()
    optimizer, scheduler = make_optimizer(model.parameters(), **optimizer_kwargs)
    return TrainState(model, optimizer, scheduler)


def stage_losses(results, targets: Dict[str, torch.Tensor], lambda_h: float, lambda_d: float,
                 sample_weight: Optional[torch.Tensor] = None):
    """Per-stage ``(l_h, l_d, l_u)`` scalar losses, reference reductions.

    ``results``: the model's per-stage (heatmaps, depthmaps ``[B, J, H, W]``,
    uvd ``[B, J, 3]``); ``targets``: heatmaps and dmaps ``[B, J, H, W]``
    (NCHW, the model's layout), uvd ``[B, J, 3]``. ``sample_weight`` ``[B]``
    (0/1) masks samples out; the mean then divides by the number of the
    others (at least 1), over the global batch in a distributed run.
    """
    hm_t = targets["heatmaps"].to(torch.float32)
    dm_t = targets["dmaps"].to(torch.float32)
    uvd_t = targets["uvd"].to(torch.float32)
    sw, denom_bj = _weights(sample_weight, hm_t.shape[0], hm_t.shape[1], hm_t.device)

    out = []
    for heatmaps, depthmaps, uvd in results:
        hm = heatmaps.to(torch.float32)
        dm = depthmaps.to(torch.float32)
        l_h = lambda_h * torch.sum(torch.sum((hm - hm_t) ** 2, dim=(2, 3)) * sw) / denom_bj
        l_d = lambda_d * torch.sum(torch.sum((dm - dm_t) ** 2, dim=(2, 3)) * sw) / denom_bj
        l_u = torch.sum(torch.sum((uvd.to(torch.float32) - uvd_t) ** 2, dim=2) * sw) / denom_bj
        out.append((l_h, l_d, l_u))
    return out


def _weights(sample_weight, b: int, joints: int, device):
    """``sample_weight`` (ones if None) as ``[B, 1]`` f32, and the mean's
    denominator: the global batch's weight sum (at least 1) times J."""
    if sample_weight is None:
        sw = torch.ones(b, dtype=torch.float32, device=device)
    else:
        sw = sample_weight.to(torch.float32)
    denom_bj = torch.clamp_min(mesh.all_reduce_sum(torch.sum(sw)), 1.0) * joints
    return sw[:, None], denom_bj


def uvd_losses(results, uvd, sample_weight=None):
    """The FullRegression family's per-stage uvd losses: ``mean_{B,J} sum_3
    (uvd - uvd*)^2`` over the weighted samples (JAX ``cli/train_main.py:365-379``)."""
    uvd_t = uvd.to(torch.float32)
    sw, denom = _weights(sample_weight, uvd_t.shape[0], uvd_t.shape[1], uvd_t.device)
    return [torch.sum(torch.sum((u.to(torch.float32) - uvd_t) ** 2, dim=2) * sw) / denom
            for u in results]


def _padded(per_stage):
    """Per-stage uvd losses as the logger's ``[stages, 3]`` (h, d, u) rows."""
    u = torch.stack(per_stage).detach()
    return torch.stack([torch.zeros_like(u), torch.zeros_like(u), u], dim=1)


def _global(*tensors):
    """Each tensor summed over the ranks, in one all-reduce."""
    if not mesh.active():
        return tensors
    flat = mesh.all_reduce_sum(torch.cat([t.detach().reshape(-1).to(torch.float32)
                                          for t in tensors]))
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].reshape(t.shape))
        offset += t.numel()
    return out


def _local_draws(cfg: PreprocessConfig, augment: bool, batch, generator, draws):
    """In a distributed run, the global batch's augmentation draws from
    ``generator``, sliced to this rank; otherwise ``draws`` as given."""
    if draws is not None or not mesh.active() or not (augment and cfg.augmentation):
        return draws
    if generator is None:
        raise ValueError("the augmented path needs draws or a generator")
    b = batch["com"].shape[0]
    full = draw_augmentation(b * mesh.world_size(), generator, batch["com"].device)
    return {k: mesh.local_slice(v) for k, v in full.items()}


def _sample_weight(valid, weight):
    """``valid`` times ``weight``, either of them absent (None), as f32;
    None where both are."""
    sw = None if valid is None else valid.to(torch.float32)
    if weight is not None:
        w = weight.to(torch.float32)
        sw = w if sw is None else sw * w
    return sw


def _require_cfg(preprocess_cfg):
    if preprocess_cfg is None:
        raise ValueError("the FullRegression steps take raw batches: preprocess_cfg is required")


# the train step's phases, each from its boundary i to boundary i + 1
PHASES = ("train.preprocess", "train.forward", "train.backward", "train.optimizer")


class _Boundaries:
    """A train step's boundaries 0..4, where its phases are defined:
    ``mark(i)`` records the caller's CUDA event ``i`` (``events=``) and
    moves the step's span (``obs``) from phase ``i - 1`` to phase ``i``.
    Leaving it as a context closes a phase still open (a step that raised)."""

    def __init__(self, events: Optional[Sequence[torch.cuda.Event]]):
        self.events = events
        self.phase = None

    def __call__(self, i: int):
        if self.events is not None:
            self.events[i].record()
        self.__exit__()
        if i < len(PHASES):
            self.phase = obs.span(PHASES[i])
            self.phase.__enter__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.phase is not None:
            self.phase.__exit__(None, None, None)
            self.phase = None


def _update(state: TrainState, loss, mark):
    """Backward, the gradients summed over the ranks, the optimizer and
    schedule steps."""
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    mesh.all_reduce_grads(state.model.parameters())
    mark(3)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    mark(4)


def _error_sums(results_uvd, data, camera: Camera, weight):
    """Per stage, the weighted sum over samples of the mean 3-D joint error (mm)."""
    box = data["box_size"].to(torch.float32)
    com = data["com"].to(torch.float32)
    cube = data["cube"].to(torch.float32)
    true_xyz = camera.uvd2xyz(recover_uvd(data["uvd"].to(torch.float32), box, com, cube))
    err_sums = []
    for uvd in results_uvd:
        xyz = camera.uvd2xyz(recover_uvd(uvd.to(torch.float32), box, com, cube))
        err = torch.sqrt(torch.sum((xyz - true_xyz) ** 2, dim=-1))  # [B, J]
        err_sums.append(torch.sum(torch.mean(err, dim=-1) * weight))
    return torch.stack(err_sums)


def total_loss(every_loss, alpha: float):
    loss = 0.0
    for l_h, l_d, l_u in every_loss:
        loss = loss + alpha * l_u + (1.0 - alpha) * (l_h + l_d)
    return loss


def model_inputs(data):
    """NHWC one-channel img, label_img and mask -> NCHW. ``unsqueeze`` gives
    plain NCHW strides (a permute would read as channels_last to cuDNN)."""
    return [data[k][..., 0].unsqueeze(1) for k in ("img", "label_img", "mask")]


def _targets(data):
    return {"heatmaps": data["heatmaps"].permute(0, 3, 1, 2),
            "dmaps": data["dmaps"].permute(0, 3, 1, 2), "uvd": data["uvd"]}


def _stacked(every):
    return torch.stack([torch.stack(list(e)) for e in every]).detach()


def make_train_step(preprocess_cfg: Optional[PreprocessConfig], loss_cfg: LossConfig,
                    augment: bool = True):
    """Build the train step ``step(state, batch, generator=None, draws=None, events=None)``.

    The step takes a raw batch (frames + crop integers, and ``joints``) and
    preprocesses it on the device, with the augmentation draws from
    ``draws`` or ``generator`` (``data.preprocess.preprocess_batch``). An
    optional ``weight`` ``[B]`` masks padded samples.

    With ``preprocess_cfg`` None the batch is already preprocessed, in
    ``preprocess_batch``'s layout: img, label_img and mask ``[B, H, W, 1]``,
    heatmaps and dmaps ``[B, h, w, J]``, uvd ``[B, J, 3]``, and optionally
    valid and weight ``[B]``, which mask samples where given (all count
    where neither is). ``augment``, ``generator`` and ``draws`` are not read.

    It runs the model in train mode, takes one optimizer and schedule step,
    leaves this step's gradients in the params' ``.grad``, and returns
    ``{"loss": [], "stage_losses": [stages, 3] (h, d, u)}`` on the device.
    ``events``, five ``torch.cuda.Event``s, are recorded before the
    preprocess, after it, after the forward and loss, after the backward and
    after the optimizer step, so a caller can time the step's parts. While a
    profiler runs, the step records the span ``train.step`` and, between the
    same boundaries, its phases ``PHASES`` (``obs``).
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             events: Optional[Sequence[torch.cuda.Event]] = None):
        with obs.span("train.step"), _Boundaries(events) as mark:
            mark(0)
            if preprocess_cfg is None:
                data = batch
            else:
                with torch.no_grad():
                    data = preprocess_batch(
                        batch, preprocess_cfg, augment=augment, generator=generator,
                        draws=_local_draws(preprocess_cfg, augment, batch, generator, draws))
            sw = _sample_weight(data.get("valid"), batch.get("weight"))
            mark(1)

            model = state.model.train()
            results = model(*model_inputs(data))
            every = stage_losses(results, _targets(data), loss_cfg.lambda_h, loss_cfg.lambda_d,
                                 sw)
            loss = total_loss(every, loss_cfg.alpha)
            mark(2)
            _update(state, loss, mark)
            loss, stage = _global(loss, _stacked(every))
            return {"loss": loss.detach(), "stage_losses": stage}

    return step


def make_train_step_fullreg(preprocess_cfg: PreprocessConfig):
    """The FullRegression family's train step ``step(state, batch,
    generator=None, draws=None, events=None)`` (JAX
    ``make_train_step_fullreg``): always augmented, the uvd loss alone over
    the valid samples (a ``weight`` field is not read, as in JAX). Returns
    ``{"loss", "stage_losses" [stages, 3]}`` with the uvd loss in the last
    column; ``events`` and the spans as ``make_train_step``'s."""
    _require_cfg(preprocess_cfg)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             events: Optional[Sequence[torch.cuda.Event]] = None):
        with obs.span("train.step"), _Boundaries(events) as mark:
            mark(0)
            with torch.no_grad():
                data = preprocess_batch(
                    batch, preprocess_cfg, augment=True, generator=generator,
                    draws=_local_draws(preprocess_cfg, True, batch, generator, draws))
            mark(1)
            model = state.model.train()
            per_stage = uvd_losses(model(*model_inputs(data)), data["uvd"],
                                   data["valid"].to(torch.float32))
            loss = sum(per_stage)
            mark(2)
            _update(state, loss, mark)
            loss, stage = _global(loss, _padded(per_stage))
            return {"loss": loss.detach(), "stage_losses": stage}

    return step


def make_eval_step(preprocess_cfg: Optional[PreprocessConfig], loss_cfg: LossConfig,
                   camera: Camera):
    """Build the eval step ``step(state, batch)``: losses and the per-stage
    sum of the per-sample mean 3-D joint error (mm), weighted by ``weight``
    (1 real, 0 padding), computed on the device in eval mode. With
    ``preprocess_cfg`` None the batch is already preprocessed (as
    ``make_train_step``'s) and also carries box_size, com and cube.

    Returns ``{"loss", "stage_losses" [stages, 3], "err_sum_mm" [stages],
    "count"}``; the mean error of stage s is ``err_sum_mm[s] / count``.
    """

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model.eval()
        with torch.no_grad():
            data, weight = _eval_data(batch, preprocess_cfg)
            results = model(*model_inputs(data))
            every = stage_losses(results, _targets(data), loss_cfg.lambda_h, loss_cfg.lambda_d,
                                 weight)
            loss = total_loss(every, loss_cfg.alpha)
            out = _global(loss, _stacked(every), _error_sums([r[2] for r in results], data,
                                                              camera, weight),
                          torch.sum(weight))
        return dict(zip(("loss", "stage_losses", "err_sum_mm", "count"), out))

    return step


def _eval_data(batch, preprocess_cfg):
    data = batch if preprocess_cfg is None else preprocess_batch(batch, preprocess_cfg)
    weight = batch.get("weight")
    if weight is None:
        weight = torch.ones(data["img"].shape[0], device=data["img"].device)
    return data, weight.to(torch.float32)


def make_eval_step_fullreg(preprocess_cfg: PreprocessConfig, camera: Camera):
    """The FullRegression family's eval step ``step(state, batch)`` (JAX
    ``make_eval_step_fullreg``): the weighted uvd losses and mean 3-D joint
    error, as ``make_eval_step``'s dict (stage losses padded to (0, 0, u))."""
    _require_cfg(preprocess_cfg)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model.eval()
        with torch.no_grad():
            data, weight = _eval_data(batch, preprocess_cfg)
            results = model(*model_inputs(data))
            per_stage = uvd_losses(results, data["uvd"], weight)
            out = _global(sum(per_stage), _padded(per_stage),
                          _error_sums(results, data, camera, weight), torch.sum(weight))
        return dict(zip(("loss", "stage_losses", "err_sum_mm", "count"), out))

    return step


def heatmap_loss(heatmaps, target, sample_weight=None):
    """V2V-PoseNet's loss: the mean squared error ``mean_{B,J,voxels} (h -
    h*)^2`` over the weighted samples (over the global batch in a
    distributed run)."""
    b, joints = target.shape[:2]
    sw, denom = _weights(sample_weight, b, joints, target.device)
    per = torch.sum((heatmaps.to(torch.float32) - target) ** 2, dim=(2, 3, 4))
    return torch.sum(per * sw) / (denom * target[0, 0].numel())


def _v2v_draws(cfg: voxel.VoxelConfig, batch, generator, draws):
    """``draws`` as given, or the global batch's from ``generator`` sliced
    to this rank."""
    if draws is not None:
        return draws
    if generator is None:
        raise ValueError("the V2V step needs draws or a generator")
    b = batch["com"].shape[0]
    full = voxel.draw_augmentation(b * mesh.world_size(), generator, batch["com"].device, cfg)
    return {k: mesh.local_slice(v) for k, v in full.items()}


def v2v_inputs(cfg: voxel.VoxelConfig, batch, draws):
    """The grids and the targets of a raw batch (``frame``, ``com``,
    ``joints``) under ``draws``, and the rows of ``voxel.coefficients``;
    the spans ``train.voxelize`` and ``train.targets``."""
    with obs.span("train.voxelize"):
        coef = voxel.coefficients(batch["com"], draws, cfg)
        grid = voxel.voxelize(batch["frame"], coef, cfg.side)
    with obs.span("train.targets"):
        target = voxel.targets(batch["joints"], coef, cfg.out_side, cfg.sigma)
    return grid, target, coef


def make_train_step_v2v(cfg: voxel.VoxelConfig):
    """V2V-PoseNet's train step ``step(state, batch, generator=None,
    draws=None, events=None)``, with ``make_train_step_fullreg``'s contract:
    the raw batch (``frame``, ``com``, ``joints``; an optional ``weight``)
    voxelised with the augmentation ``draws`` (``voxel.draw_augmentation``'s,
    or drawn from ``generator``), the targets made, both on the device
    (boundaries 0 -> 1); the forward in train mode and ``heatmap_loss`` (1
    -> 2); backward, optimizer and schedule (2 -> 4). Returns ``{"loss",
    "stage_losses" [1, 3]}`` with the loss in the last column."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             events: Optional[Sequence[torch.cuda.Event]] = None):
        with obs.span("train.step"), _Boundaries(events) as mark:
            mark(0)
            with torch.no_grad():
                grid, target, _ = v2v_inputs(cfg, batch, _v2v_draws(cfg, batch, generator,
                                                                    draws))
            mark(1)
            model = state.model.train()
            loss = heatmap_loss(model(grid), target, batch.get("weight"))
            mark(2)
            _update(state, loss, mark)
            loss, stage = _global(loss, _padded([loss]))
            return {"loss": loss.detach(), "stage_losses": stage}

    return step


def decode_v2v(heatmaps: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """The paper's decode: each joint's argmax voxel ``[B, J, S, S, S]`` ->
    world xyz (mm) ``[B, J, 3]``."""
    b, j, s = heatmaps.shape[:3]
    flat = torch.argmax(heatmaps.reshape(b, j, -1), dim=-1)
    index = torch.stack([flat % s, flat // s % s, flat // (s * s)], dim=-1)
    return voxel.world_from_grid(index, coef)


def make_eval_step_v2v(cfg: voxel.VoxelConfig, camera: Camera):
    """V2V-PoseNet's eval step ``step(state, batch)``: no augmentation, the
    model in eval mode (BatchNorm's running statistics), the loss and the
    mean 3-D joint error of the argmax decode (``decode_v2v``), weighted by
    ``weight``; ``make_eval_step``'s dict with one stage."""

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        model = state.model.eval()
        with torch.no_grad():
            b = batch["com"].shape[0]
            draws = voxel.no_augmentation(b, batch["frame"].device)
            grid, target, coef = v2v_inputs(cfg, batch, draws)
            heatmaps = model(grid)
            weight = batch.get("weight")
            weight = (torch.ones(b, device=grid.device) if weight is None
                      else weight.to(torch.float32))
            loss = heatmap_loss(heatmaps, target, weight)
            xyz = decode_v2v(heatmaps, coef)
            err = torch.sqrt(torch.sum((xyz - camera.uvd2xyz(batch["joints"].to(torch.float32)))
                                       ** 2, dim=-1))
            errs = torch.sum(torch.mean(err, dim=-1) * weight)[None]
            out = _global(loss, _padded([loss]), errs, torch.sum(weight))
        return dict(zip(("loss", "stage_losses", "err_sum_mm", "count"), out))

    return step
