"""Training entry point shared by ``cli/train.py``, ``cli/train_msra.py``,
``cli/train_fullregression.py`` and ``cli/train_v2v.py`` (mirrors
``pixelwiseregression_tpu/cli/train_main.py``, which has no V2V-PoseNet).

The loop is the JAX package's: raw host batches from the threaded
``Loader`` go to the device (pinned memory, non-blocking copies), where one
train step runs the preprocess with augmentation and label synthesis, the
forward through K1, the backward through K2 and AdamW; the eval step
computes the mean-mm metric on the device; every epoch writes a checkpoint
``Model/<log_name>_<epoch>.pt`` and the best epoch (last stage's val
mean-mm) is copied to ``<log_name>_final.pt``. TensorBoard scalars and
images go through tensorboardX where it is installed (a null writer
otherwise; ``PWR_TB_IMAGES=0`` skips the images).

``family`` names the model trained: ``"pixelwise"`` (the default),
``"fullregression"`` (the FullRegression family: its model, the uvd-only
steps of ``make_train_step_fullreg``, the val loss ``sum`` of the stage
losses and images without maps) or ``"v2v"`` (V2V-PoseNet,
``cli/train_v2v.py``: the frames voxelised on the device at
``VoxelConfig``'s published cube and sigma, the heatmap loss, the val
error of the argmax decode, no images).

Under ``torchrun --nproc_per_node N`` (``WORLD_SIZE`` and ``RANK`` set)
each process joins the process group (``parallel/mesh.py``: NCCL on the
card, gloo on the CPU; a rank's card is ``cuda:LOCAL_RANK``), loads its
``process_local_lines`` of the index at ``batch_size // N`` a batch (the
batch must divide), and the steps compute the global batch's step on every
rank. Every rank takes the same number of train steps and val batches (a
rank with fewer val lines runs zero-weight batches). Rank 0 alone prints,
logs and writes the checkpoints and the final alias.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from pixelwiseregression_tpu_torch.cli.common import (
    make_model_param,
    model_kwargs_from_args,
    resolve_device,
    resolve_num_workers,
)
from pixelwiseregression_tpu_torch.data.loader import Loader, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import get_source
from pixelwiseregression_tpu_torch.models.fullregression import FullRegression
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression
from pixelwiseregression_tpu_torch.models.v2v import V2VPoseNet
from pixelwiseregression_tpu_torch.ops.voxel import VoxelConfig
from pixelwiseregression_tpu_torch.parallel import mesh
from pixelwiseregression_tpu_torch.train.checkpoint import (
    alias_final,
    load_checkpoint,
    restore_train_state,
    save_checkpoint,
)
from pixelwiseregression_tpu_torch.train.loop import (
    LossConfig,
    create_train_state,
    make_eval_step,
    make_eval_step_fullreg,
    make_eval_step_v2v,
    make_train_step,
    make_train_step_fullreg,
    make_train_step_v2v,
    model_inputs,
)
from pixelwiseregression_tpu_torch.utils.seeding import setup_seed


class _NullWriter:
    def add_scalar(self, *a, **k): ...
    def add_scalars(self, *a, **k): ...
    def add_image(self, *a, **k): ...
    def add_figure(self, *a, **k): ...
    def close(self): ...


def _writer(log_name: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError as e:
        import warnings

        warnings.warn(f"tensorboardX unavailable ({e}): training continues WITHOUT "
                      "TensorBoard logging (scalars and images dropped)")
        return _NullWriter()
    return SummaryWriter(os.path.join("logs", log_name))


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _write_trace(profiler, profile_dir: str, device: torch.device):
    _synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    print(f"profile trace written to {profile_dir}")


def _log_images(writer, epoch, model, batch, pp_val, config, device, fullregression=False):
    """Per-epoch image logging on one val batch: the input, its labels and
    each stage's maps (none for FullRegression) and skeleton."""
    from pixelwiseregression_tpu_torch.utils.viz import draw_features, draw_skeleton_normalized

    with torch.no_grad():
        data = preprocess_batch(to_device(batch, device), pp_val)
        results = model.eval()(*model_inputs(data))
    img0 = data["img"][0, :, :, 0].float().cpu().numpy()
    writer.add_image("input_image",
                     data["img"][0].float().cpu().numpy().transpose(2, 0, 1)
                     / max(float(np.abs(img0).max()), 1e-6), epoch)
    if not fullregression:
        writer.add_figure("input_heatmap", draw_features(data["heatmaps"][0].cpu().numpy()),
                          epoch)
        writer.add_figure("input_depthmap", draw_features(data["dmaps"][0].cpu().numpy()), epoch)
    skel = draw_skeleton_normalized(img0, data["uvd"][0].cpu().numpy(), config)
    writer.add_image("input_skeleton", skel.transpose(2, 0, 1), epoch)
    for i, result in enumerate(results):
        if fullregression:
            uvd = result
        else:
            hm, dm, uvd = result
            writer.add_figure(f"stage{i}_heatmap",
                              draw_features(hm[0].float().permute(1, 2, 0).cpu().numpy()), epoch)
            writer.add_figure(f"stage{i}_depthmap",
                              draw_features(dm[0].float().permute(1, 2, 0).cpu().numpy()), epoch)
        skel = draw_skeleton_normalized(img0, uvd[0].float().cpu().numpy(), config)
        writer.add_image(f"stage{i}_skeleton", skel.transpose(2, 0, 1), epoch)


def _val_batches(loader, n: int):
    """``loader``'s batches, then zero-weight copies of its last one up to
    ``n`` in all, so that every rank runs ``n`` eval steps."""
    last = None
    for last in loader:
        yield last
        n -= 1
    if n > 0 and last is None:
        raise RuntimeError("a rank holds no val sample; the val split is smaller than the "
                           "number of processes")
    for _ in range(n):
        yield dict(last, weight=np.zeros_like(last["weight"]), count=np.int32(0))


FAMILIES = ("pixelwise", "fullregression", "v2v")


def run_training(args, dataset_name: str, family: str = "pixelwise", subject=None):
    """Train on ``dataset_name`` (``subject``: MSRA's held-out subject) as the
    flags say; returns ``(best_epoch, best_error)`` (the last stage's val
    mean-mm at the best epoch). Under torchrun, joins the process group
    for the run."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r}, expected one of {FAMILIES}")
    own_group = mesh.launched() and not mesh.active()
    device = resolve_device(args)
    if own_group:
        device = mesh.init(device.type)
    try:
        return _run_training(args, dataset_name, family, subject, device)
    finally:
        if own_group:
            mesh.shutdown()


def _run_training(args, dataset_name, family, subject, device):
    fullregression, v2v = family == "fullregression", family == "v2v"
    world, main_rank = mesh.world_size(), mesh.rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    if main_rank:
        os.makedirs("Model", exist_ok=True)

    seed = args.seed if args.seed else int(np.random.randint(0, 100000))
    seed = mesh.broadcast_object(seed)
    setup_seed(seed)

    source_kw = dict(path=args.data_path, cube_size=None)
    if subject is not None:
        source_kw["subject"] = subject
    small = getattr(args, "small", False)
    trainset = get_source(dataset_name, dataset="small_train" if small else "train", **source_kw)
    valset = get_source(dataset_name, dataset="small_val" if small else "val", **source_kw)
    joints = trainset.joint_number
    cam = trainset.spec.camera

    image_size = args.label_size * 2
    common = dict(fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv, image_size=image_size,
                  label_size=args.label_size, kernel_size=args.kernel_size, sigma=args.sigmoid)
    pp_train = PreprocessConfig(
        **common, using_rotation=args.using_rotation, using_scale=args.using_scale,
        using_shift=args.using_shift, using_flip=args.using_flip,
        strict_quirks=not args.no_strict_quirks,
        aug_fallback=getattr(args, "aug_fallback", "clean"))
    pp_val = PreprocessConfig(**common)

    num_workers = resolve_num_workers(args.num_workers)
    if args.batch_size % world:
        raise ValueError(f"batch_size {args.batch_size} must divide over {world} processes")
    local_bs = args.batch_size // world
    # each process loads its interleaved slice of the index; the local
    # batches make up the global batch
    train_lines = mesh.process_local_lines(trainset.lines)
    val_lines = mesh.process_local_lines(valset.lines)
    train_loader = Loader(trainset, local_bs, shuffle=True, drop_last=True,
                          num_workers=num_workers, seed=seed, lines=train_lines)
    val_loader = Loader(valset, local_bs, shuffle=False, drop_last=False,
                        num_workers=num_workers, lines=val_lines)
    # every rank takes as many steps: the global count (each rank holds at
    # least that many full local batches) and the largest rank's val batches
    train_steps = len(trainset.lines) // args.batch_size
    val_steps = -(-(-(-len(valset.lines) // world)) // local_bs)
    say(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else "")
        + (f", {world} processes of batch {local_bs} "
           f"({torch.distributed.get_backend()})" if mesh.active() else ""))

    if v2v:
        model_kw = dict(joints=joints, in_size=args.in_size)
        model = V2VPoseNet(**model_kw).to(device)
        vcfg = VoxelConfig(
            fx=cam.fx, fy=cam.fy, halfu=cam.halfu, halfv=cam.halfv, side=args.in_size,
            rotation=40.0 if args.using_rotation else 0.0,
            scale=(0.8, 1.2) if args.using_scale else (1.0, 1.0),
            shift=8.0 if args.using_shift else 0.0)
        model_param = dict(model_kw, family="v2v", cube=vcfg.cube, dtype="float32")
    else:
        model_kw = model_kwargs_from_args(args, joints, fullregression=fullregression)
        model = (FullRegression if fullregression else PixelwiseRegression)(**model_kw).to(device)
        model_param = make_model_param(model_kw, args.label_size)
    mesh.broadcast_module(model)

    # a floor of 1 so that the schedule never divides by zero
    steps_per_epoch = max(len(trainset.lines) // args.batch_size, 1)
    say(f"there are {steps_per_epoch} steps per epoch!")
    state = create_train_state(
        model, opt=args.opt, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
        weight_decay=args.weight_decay, lr_decay=args.lr_decay,
        decay_epoch=int(args.decay_epoch), steps_per_epoch=steps_per_epoch)

    if getattr(args, "resume", None):
        restore_train_state(state, load_checkpoint(args.resume))
        say(f"resumed from {args.resume} at step {state.step}")

    if v2v:
        loss_cfg = None
        train_step = make_train_step_v2v(vcfg)
        eval_step = make_eval_step_v2v(vcfg, cam)
    elif fullregression:
        loss_cfg = None
        train_step = make_train_step_fullreg(pp_train)
        eval_step = make_eval_step_fullreg(pp_val, cam)
    else:
        loss_cfg = LossConfig(lambda_h=args.lambda_h, lambda_d=args.lambda_d, alpha=args.alpha)
        train_step = make_train_step(pp_train, loss_cfg, augment=True)
        eval_step = make_eval_step(pp_val, loss_cfg, cam)
    # the augmentation draws, from a generator of their own on the device
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    log_name = f"{dataset_name}_{args.suffix}"
    if subject is not None:
        log_name = f"{dataset_name}_{args.suffix}_subject{subject}"
    model_name = log_name + "_{}.pt"
    writer = _writer(log_name) if main_rank else _NullWriter()

    best_epoch, best_error = 0, float("inf")
    step_count = 0
    viz_batch = None
    profile_dir = getattr(args, "profile", None)
    profiler = None

    for epoch in range(args.epoch):
        # ---- train ----
        t0 = time.time()
        epoch_steps = 0
        for batch in itertools.islice(train_loader, train_steps):
            batch.pop("count", None)
            if profile_dir is not None and step_count == 3:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.start()
            metrics = train_step(state, to_device(batch, device), generator=generator)
            if profiler is not None and step_count == 6:
                _write_trace(profiler, profile_dir, device)
                profile_dir = profiler = None
            step_count += 1
            epoch_steps += 1
        _synchronize(device)
        train_elapsed = time.time() - t0
        if step_count == 0:
            raise RuntimeError(f"no training batches: {len(trainset.lines)} samples < "
                               f"batch_size {args.batch_size} with drop_last")
        train_loss = float(metrics["loss"])
        stage_l = metrics["stage_losses"].cpu().numpy()

        # ---- eval ----
        val_losses, val_errs, n_total, n_batches = None, None, 0.0, 0
        for batch in _val_batches(val_loader, val_steps):
            batch.pop("count")
            if viz_batch is None:
                viz_batch = {k: v for k, v in batch.items() if np.ndim(v)}
            m = eval_step(state, to_device(batch, device))
            errs = m["err_sum_mm"].cpu().numpy()  # [stages]
            sl = m["stage_losses"].cpu().numpy()
            if val_errs is None:
                val_errs, val_losses = errs, sl
            else:
                val_errs = val_errs + errs
                val_losses = val_losses + sl
            n_total += float(m["count"])
            n_batches += 1
        val_errs = val_errs / max(n_total, 1.0)
        val_losses = val_losses / max(n_batches, 1)

        # samples/s of the train phase (epoch 0 includes the kernels' build)
        fps = epoch_steps * args.batch_size / max(train_elapsed, 1e-9)
        say(f"epoch {epoch}: train_loss {train_loss:.5f}  "
            f"val mean-mm {np.array2string(val_errs, precision=3)}  ({fps:.1f} samples/s)")

        # PWR_TB_IMAGES=0 skips the images (one more forward an epoch)
        if (viz_batch is not None and not v2v and not isinstance(writer, _NullWriter)
                and os.environ.get("PWR_TB_IMAGES", "1") != "0"):
            try:
                _log_images(writer, epoch, state.model, viz_batch, pp_val, trainset.config,
                            device, fullregression)
            except Exception as e:  # viz must never kill a training run
                print(f"image logging failed: {type(e).__name__}: {e}")

        # ---- tensorboard scalars ----
        n_stages = stage_l.shape[0]
        if fullregression or v2v:
            val_total = float(np.sum(val_losses))
        else:
            val_total = float(sum(
                loss_cfg.alpha * val_losses[i][2]
                + (1 - loss_cfg.alpha) * (val_losses[i][0] + val_losses[i][1])
                for i in range(n_stages)))
        writer.add_scalars("loss", {"train": train_loss, "val": val_total}, epoch)
        for i in range(n_stages):
            for j, name in enumerate(() if fullregression or v2v
                                     else ("heatmap", "depthmap", "uvd")):
                writer.add_scalars(f"stage{i}_{name}_loss",
                                   {"train": float(stage_l[i][j]), "val": float(val_losses[i][j])},
                                   epoch)
            writer.add_scalar(f"stage{i}_result", float(val_errs[i]), epoch)

        # ---- checkpoint ----
        if main_rank:
            save_checkpoint(os.path.join("Model", model_name.format(epoch)), state.model,
                            seed=seed, model_param=model_param, optimizer=state.optimizer,
                            scheduler=state.scheduler, step=state.step)
        if float(val_errs[-1]) < best_error:
            best_epoch = epoch
            best_error = float(val_errs[-1])

    if profiler is not None:  # fewer than 7 steps: the trace of those after step 3
        _write_trace(profiler, profile_dir, device)
    say(f"best epoch is {best_epoch}")
    if main_rank:
        alias_final("Model", model_name, best_epoch)
    writer.close()
    return best_epoch, best_error
