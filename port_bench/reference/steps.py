"""The reference's train steps and serving call, on the inputs the harness
hands to both sides (weights, raw batches, augmentation draws, frames and
hand centres). Plain PyTorch and NumPy; nothing of the program.

Train: the per-stage losses (PixelwiseRegression: ``alpha * L_uvd + (1 -
alpha) * (lambda_h * L_heatmap + lambda_d * L_depth)``; FullRegression:
``L_uvd``), each ``mean_{B,J}`` of a sum over the map or the three
coordinates, over the samples that are valid; AdamW by its formula with
the step-decay schedule. A step runs its forward and backward in blocks of
rows, each block's loss over the whole batch's denominator, so that the
gradient is the whole batch's and the memory a block's.

Serve: the float64 crop integers, the test-time preprocess, the forward in
eval mode, the last stage's uvd de-normalised into the frame, and world xyz.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import model as ref_model
from port_bench.reference import preprocess as ref_pp


def _float32() -> None:
    """The reference's products in float32: no TF32 on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _load(net, weights):
    """``net`` on the weights' device, holding a copy of them."""
    net = net.to(next(iter(weights.values())).device)
    net.load_state_dict({k: v.detach().clone() for k, v in weights.items()}, strict=True)
    return net


def _losses(cfg, results, data, sw, denom):
    m = cfg["model"]
    loss = 0.0
    if m["class"] == "FullRegression":
        for uvd in results:
            loss = loss + torch.sum(torch.sum((uvd - data["uvd"]) ** 2, dim=2) * sw) / denom
        return loss
    lo = cfg["loss"]
    for hm, dm, uvd in results:
        l_h = lo["lambda_h"] * torch.sum(torch.sum((hm - data["heatmaps"]) ** 2, dim=(2, 3)) * sw)
        l_d = lo["lambda_d"] * torch.sum(torch.sum((dm - data["dmaps"]) ** 2, dim=(2, 3)) * sw)
        l_u = torch.sum(torch.sum((uvd - data["uvd"]) ** 2, dim=2) * sw)
        loss = loss + (lo["alpha"] * l_u + (1.0 - lo["alpha"]) * (l_h + l_d)) / denom
    return loss


class AdamW:
    """torch's AdamW update, written out: ``m = b1 m + (1-b1) g``, ``v = b2 v
    + (1-b2) g^2``, ``p -= lr_t * wd * p`` then ``p -= lr_t / (1-b1^t) * m /
    (sqrt(v) / sqrt(1-b2^t) + eps)``, with ``lr_t = lr * decay ** ((t //
    steps_per_epoch) // decay_epoch)`` for the step ``t`` counted from 0."""

    def __init__(self, params, opt: dict):
        self.params = list(params)
        self.o = opt
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        o = self.o
        lr = o["lr"] * o["lr_decay"] ** ((self.t // o["steps_per_epoch"]) // o["decay_epoch"])
        self.t += 1
        b1, b2 = o["beta1"], o["beta2"]
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            p.mul_(1.0 - lr * o["weight_decay"])
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
            denom = v.sqrt() / (1.0 - b2 ** self.t) ** 0.5 + o["eps"]
            p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** self.t))


def train_steps(cfg: dict, weights: dict, batches, draws, rows: int, tf32: bool = False,
                half_batch: bool = False) -> dict:
    """Follow the program's first ``len(batches)`` train steps from
    ``weights`` on the same raw batches (tensors on the device) and draws.

    Returns each step's loss, each leaf's gradient norm at the first step
    and each leaf's change after the last, by name. ``tf32`` is the
    control; ``half_batch`` a fault: the loss over the first half of each
    batch only, its mean over those samples.
    """
    _float32()
    pp = cfg["preprocess"]
    net = _load(ref_model.build(cfg, cfg["norm"]["train"], tf32), weights).train()
    params = dict(net.named_parameters())
    opt = AdamW(params.values(), cfg["optimizer"])
    joints = cfg["model"]["joints"]
    losses, grad_norms = [], None
    for batch, d in zip(batches, draws):
        with torch.no_grad():
            data = ref_pp.preprocess(batch, pp, draws=d if pp["augment"] else None)
        sw = data["valid"].to(torch.float32)
        b = sw.shape[0]
        if half_batch:
            sw = torch.cat([sw[: b // 2], torch.zeros_like(sw[b // 2:])])
        denom = torch.clamp_min(sw.sum(), 1.0) * joints
        for p in params.values():
            p.grad = None
        total = 0.0
        for lo in range(0, b, rows):
            part = {k: v[lo:lo + rows] for k, v in data.items()}
            results = net(part["img"], part["label_img"], part["mask"])
            loss = _losses(cfg, results, part, sw[lo:lo + rows, None], denom)
            loss.backward()
            total = total + loss.detach()
        ref_model.commit_anchors(net)
        opt.step()
        losses.append(float(total))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in params.items()}
    change = {k: float(torch.linalg.vector_norm(p.detach() - weights[k])) for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def host_batch(cfg: dict, frames: np.ndarray, coms: np.ndarray) -> dict:
    """The serving request's host batch: frames and each frame's crop
    integers (the configuration's default cube)."""
    ds = cfg["dataset"]
    recs = [ref_pp.crop_record(frames.shape[1:], c, ds["cube"], ds["camera"], ds["bbox_margin"])
            for c in coms]
    out = {k: np.stack([r[k] for r in recs]) for k in recs[0]}
    out["frame"] = np.ascontiguousarray(frames, np.float32)
    return out


@torch.no_grad()
def serve(cfg: dict, weights: dict, frames: np.ndarray, coms: np.ndarray, device, rows: int,
          tf32: bool = False) -> dict:
    """The reference's answers to one request: uvd ``[N, J, 3]`` (frame
    pixels and depth mm) and world xyz ``[N, J, 3]`` mm, float32 numpy."""
    _float32()
    pp = cfg["preprocess"]
    net = _load(ref_model.build(cfg, cfg["norm"]["serve"], tf32), weights).eval()
    host = host_batch(cfg, frames, coms)
    out = []
    for lo in range(0, frames.shape[0], rows):
        batch = {k: torch.from_numpy(v[lo:lo + rows]).to(device) for k, v in host.items()}
        data = ref_pp.preprocess(batch, pp, test_only=True)
        last = net(data["img"], data["label_img"], data["mask"])[-1]
        uvd = last if cfg["model"]["class"] == "FullRegression" else last[2]
        uv = uvd[..., :2] * (data["box_size"] - 1.0)[:, None, None]
        d = uvd[..., 2] * data["cube"][:, None]
        out.append((torch.cat([uv, d[..., None]], dim=-1) + data["com"][:, None, :]).cpu())
    uvd = torch.cat(out).numpy()
    cam = cfg["dataset"]["camera"]
    x = (uvd[..., 0] - cam["halfu"]) / cam["fx"] * uvd[..., 2]
    y = (uvd[..., 1] - cam["halfv"]) / cam["fy"] * uvd[..., 2]
    return {"uvd": uvd, "xyz": np.stack([x, y, uvd[..., 2]], axis=-1)}
