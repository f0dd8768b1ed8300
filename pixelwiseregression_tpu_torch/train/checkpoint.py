"""Checkpoints: the reference ``.pt`` format with the optimizer, best-epoch
aliasing, and reading the JAX package's msgpack ``.ckpt``
(mirrors ``pixelwiseregression_tpu/train/checkpoint.py``).

Every epoch the train CLI writes ``Model/<name>_<epoch>.pt``: a
``torch.save``d ``{"state_dict", "seed", "model_param"}`` (the reference's
format, which ``serve.Predictor.from_checkpoint`` reads) plus
``"optimizer"``, ``"scheduler"`` and ``"step"``, so that training resumes
where it stopped. The anchored norms' ``anchor``/``anchor_n`` are buffers in
``state_dict``. The best epoch is copied to ``<name>_final.pt``.

``load_checkpoint`` reads three kinds of file: the port's ``.pt``, a
reference ``.pt`` (no optimizer), and the JAX package's ``.ckpt``. The last
is read without flax or jax: msgpack with flax's ndarray extension type,
then ``compat.flax_bridge.state_dict_from_flax`` for the params and
``batch_stats``; ``restore_train_state`` carries its optax state into the
torch optimizer (Adam's ``mu``/``nu`` -> ``exp_avg``/``exp_avg_sq``, SGD's
momentum ``trace`` -> ``momentum_buffer``, by the params' names; optax's
``count`` -> Adam's ``step``) and sets the schedule to the stored step.
msgpack is imported only to read a ``.ckpt``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from pixelwiseregression_tpu_torch.compat.flax_bridge import state_dict_from_flax

# flax.serialization's msgpack extension code of a numpy array
_EXT_NDARRAY = 1


def _to_cpu(obj):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(
    path: str,
    model: torch.nn.Module,
    seed: Optional[int] = None,
    model_param: Optional[Dict[str, Any]] = None,
    optimizer: Optional[torch.optim.Optimizer] = None,
    scheduler=None,
    step: Optional[int] = None,
):
    """Write ``model``'s state dict (and the optimizer's, the scheduler's and
    the step, where given) in the reference ``.pt`` format, atomically."""
    payload = {"state_dict": _to_cpu(model.state_dict()), "seed": seed,
               "model_param": model_param, "step": step}
    if optimizer is not None:
        payload["optimizer"] = _to_cpu(optimizer.state_dict())
    if scheduler is not None:
        payload["scheduler"] = scheduler.state_dict()
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


# --------------------------------------------------------------------------- #
# the JAX package's .ckpt, without flax
# --------------------------------------------------------------------------- #


def _ext_hook(code: int, data: bytes):
    """flax's ndarray extension: msgpack of (shape, dtype name, bytes)."""
    import msgpack

    if code != _EXT_NDARRAY:
        raise ValueError(f"unexpected msgpack extension type {code} in a checkpoint")
    shape, dtype, buf = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)


def msgpack_restore(blob: bytes):
    """flax.serialization.msgpack_restore, without flax, for what the JAX
    package's save_checkpoint writes: nested dicts with numpy array leaves
    (params, statistics and optimizer state, all under flax's 1 GiB chunk
    size)."""
    import msgpack

    return msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False)


def _read_ckpt(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    meta = json.loads(payload["meta"].decode())
    variables = {"params": msgpack_restore(payload["params"]),
                 "batch_stats": msgpack_restore(payload["batch_stats"])}
    opt_state = msgpack_restore(payload["opt_state"]) if "opt_state" in payload else None
    return {"state_dict": state_dict_from_flax(variables), "seed": meta.get("seed"),
            "model_param": meta.get("model_param"), "step": meta.get("step"),
            "optimizer": None, "scheduler": None, "opt_state": opt_state}


# --------------------------------------------------------------------------- #
# loading
# --------------------------------------------------------------------------- #


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Read a port ``.pt``, a reference ``.pt`` or a JAX ``.ckpt``.

    Returns ``state_dict`` (reference names; the reference's constant COM
    ``.filter`` buffers dropped), ``seed``, ``model_param``, ``step`` (None
    where the file has none), ``optimizer`` and ``scheduler`` (torch state
    dicts, port ``.pt`` only) and ``opt_state`` (the optax state tree as
    numpy, JAX ``.ckpt`` only); the missing ones are None.
    """
    if path.endswith(".ckpt"):
        return _read_ckpt(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = {k: v for k, v in ckpt["state_dict"].items() if not k.endswith(".filter")}
    return {"state_dict": state_dict, "seed": ckpt.get("seed"),
            "model_param": ckpt.get("model_param"), "step": ckpt.get("step"),
            "optimizer": ckpt.get("optimizer"), "scheduler": ckpt.get("scheduler"),
            "opt_state": None}


def _find(tree, key: str):
    """The first subtree of a nested dict (depth first) that holds ``key``."""
    if not isinstance(tree, Mapping):
        return None
    if key in tree:
        return tree
    for sub in tree.values():
        found = _find(sub, key)
        if found is not None:
            return found
    return None


def optimizer_state_from_optax(opt_state, model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """The torch state dict of ``optimizer`` (built on ``model.parameters()``)
    that carries an optax adamw or sgd state: each moment tree maps to the
    params' names as the params do (``state_dict_from_flax``, HWIO -> OIHW)."""
    names = [n for n, _ in model.named_parameters()]
    adam = _find(opt_state, "mu")
    sgd = _find(opt_state, "trace")
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    if isinstance(optimizer, (torch.optim.Adam, torch.optim.AdamW)):
        if adam is None:
            raise ValueError("the checkpoint's optimizer state is not Adam's")
        mu = state_dict_from_flax({"params": adam["mu"]})
        nu = state_dict_from_flax({"params": adam["nu"]})
        count = torch.tensor(float(adam["count"]), dtype=torch.float32)
        for i, n in enumerate(names):
            state[i] = {"step": count.clone(), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    elif isinstance(optimizer, torch.optim.SGD):
        if sgd is None:
            raise ValueError("the checkpoint's optimizer state is not SGD's with momentum")
        trace = state_dict_from_flax({"params": sgd["trace"]})
        for i, n in enumerate(names):
            state[i] = {"momentum_buffer": trace[n]}
    else:
        raise ValueError(f"no optax mapping for {type(optimizer).__name__}")
    return {"state": state, "param_groups": optimizer.state_dict()["param_groups"]}


def _seek_schedule(scheduler, step: int):
    """Set a LambdaLR (and its optimizer's lr) to where ``step`` steps leave it."""
    scheduler.last_epoch = step
    lrs = [base * fn(step) for base, fn in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
    for group, lr in zip(scheduler.optimizer.param_groups, lrs):
        group["lr"] = lr
    scheduler._last_lr = lrs


def restore_train_state(state, ckpt: Dict[str, Any]):
    """Load ``load_checkpoint``'s result into a ``train.loop.TrainState``: the
    params and buffers, the optimizer state (a port ``.pt``'s, or a JAX
    ``.ckpt``'s optax state), the schedule and the step count."""
    state.model.load_state_dict(ckpt["state_dict"])
    if ckpt["optimizer"] is not None:
        state.optimizer.load_state_dict(ckpt["optimizer"])
    elif ckpt["opt_state"] is not None:
        state.optimizer.load_state_dict(
            optimizer_state_from_optax(ckpt["opt_state"], state.model, state.optimizer))
    state.step = int(ckpt["step"] or 0)
    if ckpt["scheduler"] is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    else:
        _seek_schedule(state.scheduler, state.step)
    return state


def peek_model_param(path: str) -> Optional[Dict[str, Any]]:
    """Read just the stored model_param from a checkpoint (.pt or .ckpt)."""
    if path.endswith(".ckpt"):
        with open(path, "rb") as f:
            payload = msgpack_restore(f.read())
        return json.loads(payload["meta"].decode()).get("model_param")
    return torch.load(path, map_location="cpu", weights_only=True).get("model_param")


def alias_final(model_dir: str, name_fmt: str, best_epoch: int):
    """Copy the best epoch's checkpoint to the ``final`` alias."""
    src = os.path.join(model_dir, name_fmt.format(best_epoch))
    dst = os.path.join(model_dir, name_fmt.format("final"))
    shutil.copyfile(src, dst)
