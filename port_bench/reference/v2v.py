"""Plain PyTorch reference of V2V-PoseNet's training (Moon, Chang and Lee,
CVPR 2018, arXiv 1711.07399), on the inputs the harness hands to both
sides: weights, raw batches (``frame``, ``com``, ``joints``) and the
augmentation draws. Float32, TF32 off, nothing of the program.

* The voxeliser: for each pixel with a positive depth, ``p =
  pixel2world(u, v, d)`` (``x = (u - halfu) / fx * d``, ``y = (v - halfv) /
  fy * d``, ``z = d``), ``q = s R(theta) (p - c) + t * cube / S``, and the
  voxel ``floor((q + cube / 2) / (cube / S))`` set to 1 where it lies in the
  grid. The per-sample numbers are made by the same torch calls as the
  program's, and every step is one float32 torch op in the same order, each
  divisor a tensor on the same device, so the grids compare bit for bit.
* The targets: ``exp(-|x - x_j|^2 / (2 sigma^2))`` over the output grid,
  with ``x_j = (q_j + cube / 2) / (2 cube / S) - 0.5``, the squared
  distance summed before the exponential (the paper's formula).
* The network as the paper's Figs. 4-5 (the reimplementation's module
  names, so one weight dictionary loads into both): ``F.conv3d``,
  ``F.batch_norm`` with the batch's statistics, ``F.max_pool3d``,
  ``F.conv_transpose3d``; the loss, the mean squared error; RMSprop by its
  formula (alpha 0.99, eps 1e-8, no momentum).

Departures from the paper: the frames' given centres stand in for the
paper's reference points refined by a 2D CNN, and there is no test-time
ensemble. The step runs the whole batch at once: BatchNorm's statistics are
the batch's.

``tf32=True`` is the comparison's control: every conv's operands rounded to
TF32 (``model.round_tf32``) in the forward and in the backward's products.
``half_batch`` is a fault: the loss over the first half of each batch, its
mean over those samples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.model import _tf32_product

EPS_BN = 1e-5
MOMENTUM_BN = 0.1


def init_spec(names_shapes: dict) -> dict:
    """The published initialisation, by state-dict name: every conv's weight
    N(0, 0.001) (``("normal", 0.001)``), its bias 0; BatchNorm's scale 1,
    shift 0, running mean 0 and variance 1, its count 0."""
    spec = {}
    for k, shape in names_shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) == 5:
            spec[k] = ("normal", 0.001)
        elif leaf in ("weight", "running_var"):
            spec[k] = ("const", 1.0)
        else:
            spec[k] = ("const", 0.0)
    return spec


# --------------------------------------------------------------------------- inputs


def _pixel2world(u, v, d, c):
    return (u - c["halfu"]) / c["fx"] * d, (v - c["halfv"]) / c["fy"] * d


def _moved(x, y, z, c):
    dx, dy, dz = x - c["cx"], y - c["cy"], z - c["cz"]
    return (c["m00"] * dx + c["m01"] * dy + c["tx"], c["m10"] * dx + c["m11"] * dy + c["ty"],
            c["m22"] * dz + c["tz"])


def sample_numbers(com: torch.Tensor, draws: dict, vox: dict) -> dict:
    """Each sample's camera, centre, ``s R``, ``t * cube / S``, ``cube / 2``
    and ``cube / S`` as ``[B, 1]`` float32 tensors on ``com``'s device."""
    b, dev = com.shape[0], com.device

    def const(x):
        return torch.full((b,), x, dtype=torch.float32, device=dev)

    cam = {k: const(vox[k]) for k in ("halfu", "halfv", "fx", "fy")}
    com = com.to(torch.float32)
    cx, cy = _pixel2world(com[:, 0], com[:, 1], com[:, 2], cam)
    theta = draws["angle"].to(torch.float32) * (math.pi / 180.0)
    s = draws["scale"].to(torch.float32)
    sc, ss = s * torch.cos(theta), s * torch.sin(theta)
    cube = const(vox["cube"])
    edge = cube / const(float(vox["side"]))
    t = draws["shift"].to(torch.float32) * edge[:, None]
    out = {**cam, "cx": cx, "cy": cy, "cz": com[:, 2], "m00": sc, "m01": -ss, "m10": ss,
           "m11": sc, "m22": s, "tx": t[:, 0], "ty": t[:, 1], "tz": t[:, 2],
           "half": cube * 0.5, "vox": edge}
    return {k: v[:, None] for k, v in out.items()}


def grids(frame: torch.Tensor, c: dict, side: int) -> torch.Tensor:
    """Occupancy grids ``[B, 1, side, side, side]`` (z, y, x)."""
    b, h, w = frame.shape
    dev = frame.device
    d = frame.reshape(b, h * w).to(torch.float32)
    cols = torch.arange(w, dtype=torch.float32, device=dev)
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    u = cols[None, :].expand(h, w).reshape(1, h * w)
    v = rows[:, None].expand(h, w).reshape(1, h * w)
    x, y = _pixel2world(u, v, d, c)
    cells = [torch.floor((q + c["half"]) / c["vox"]) for q in _moved(x, y, d, c)]  # x, y, z
    inside = d > 0
    for i in cells:
        inside = inside & (i >= 0) & (i < side)
    ix, iy, iz = (torch.where(inside, i, torch.zeros_like(i)).long() for i in cells)
    sample = torch.arange(b, device=dev)[:, None].expand(b, h * w)
    # a pixel outside the grid writes a spare column past the grid's own
    out = torch.zeros((b, side, side, side + 1), dtype=torch.float32, device=dev)
    out[sample, iz, iy, torch.where(inside, ix, side)] = 1.0
    return out[..., :side].contiguous()[:, None]


def targets(joints: torch.Tensor, c: dict, out_side: int, sigma: float) -> torch.Tensor:
    """``[B, J, S, S, S]``: each joint's Gaussian on the output grid."""
    j = joints.to(torch.float32)
    x, y = _pixel2world(j[..., 0], j[..., 1], j[..., 2], c)
    qx, qy, qz = _moved(x, y, j[..., 2], c)
    at = [(q + c["half"]) / (c["vox"] * 2.0) - 0.5 for q in (qx, qy, qz)]
    r = torch.arange(out_side, dtype=torch.float32, device=joints.device)
    dz = (r[None, None, :, None, None] - at[2][..., None, None, None]) ** 2
    dy = (r[None, None, None, :, None] - at[1][..., None, None, None]) ** 2
    dx = (r[None, None, None, None, :] - at[0][..., None, None, None]) ** 2
    return torch.exp(-(dz + dy + dx) / (2.0 * sigma * sigma))


# --------------------------------------------------------------------------- network


def _conv(p, name, x, tf32, **kw):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if tf32:
        return _tf32_product(F.conv3d, x, w, b, 1, kw.get("padding", 0))
    return F.conv3d(x, w, b, 1, kw.get("padding", 0))


def _deconv(p, name, x, tf32):
    w, b = p[name + ".weight"], p[name + ".bias"]
    if tf32:
        return _tf32_product(F.conv_transpose3d, x, w, b, 2)
    return F.conv_transpose3d(x, w, b, 2)


def _bn(p, stats, name, x):
    return F.batch_norm(x, stats[name + ".running_mean"], stats[name + ".running_var"],
                        p[name + ".weight"], p[name + ".bias"], True, MOMENTUM_BN, EPS_BN)


def _basic(p, s, name, x, k, tf32):
    return F.relu(_bn(p, s, name + ".block.1", _conv(p, name + ".block.0", x, tf32,
                                                     padding=k // 2)))


def _res(p, s, name, x, tf32):
    y = F.relu(_bn(p, s, name + ".res_branch.1",
                   _conv(p, name + ".res_branch.0", x, tf32, padding=1)))
    y = _bn(p, s, name + ".res_branch.4", _conv(p, name + ".res_branch.3", y, tf32, padding=1))
    skip = x
    if name + ".skip_con.0.weight" in p:
        skip = _bn(p, s, name + ".skip_con.1", _conv(p, name + ".skip_con.0", x, tf32))
    return F.relu(y + skip)


def _up(p, s, name, x, tf32):
    return F.relu(_bn(p, s, name + ".block.1", _deconv(p, name + ".block.0", x, tf32)))


def forward(p: dict, s: dict, grid: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """The network on ``[B, 1, S, S, S]`` -> ``[B, J, S/2, S/2, S/2]``, with
    parameters ``p`` and BatchNorm's running statistics ``s`` (updated)."""
    x = _basic(p, s, "front_layers.0", grid, 7, tf32)
    x = F.max_pool3d(x, 2, 2)
    for i in (2, 3, 4):
        x = _res(p, s, f"front_layers.{i}", x, tf32)
    e = "encoder_decoder."
    s1 = _res(p, s, e + "skip_res1", x, tf32)
    x = _res(p, s, e + "encoder_res1", F.max_pool3d(x, 2, 2), tf32)
    s2 = _res(p, s, e + "skip_res2", x, tf32)
    x = _res(p, s, e + "encoder_res2", F.max_pool3d(x, 2, 2), tf32)
    x = _res(p, s, e + "decoder_res2", _res(p, s, e + "mid_res", x, tf32), tf32)
    x = _res(p, s, e + "decoder_res1", _up(p, s, e + "decoder_upsample2", x, tf32) + s2, tf32)
    x = _up(p, s, e + "decoder_upsample1", x, tf32) + s1
    x = _res(p, s, "back_layers.0", x, tf32)
    x = _basic(p, s, "back_layers.1", x, 1, tf32)
    x = _basic(p, s, "back_layers.2", x, 1, tf32)
    return _conv(p, "output_layer", x, tf32)


# --------------------------------------------------------------------------- steps


def _float32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def train_steps(cfg: dict, weights: dict, batches, draws, rows: int, tf32: bool = False,
                half_batch: bool = False) -> dict:
    """Follow the program's first ``len(batches)`` steps from ``weights``
    (the state dict, running statistics included) on the same raw batches
    (tensors on the device) and draws.

    Returns each step's loss, each parameter's gradient norm at the first
    step and its change's norm after the last, by name, and each step's
    grids. ``rows`` must hold the whole batch (BatchNorm's statistics)."""
    _float32()
    vox = {**cfg["dataset"]["camera"], **cfg["voxel"]}
    m, o = cfg["model"], cfg["optimizer"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    stats = {k: v.detach().clone() for k, v in weights.items() if k.endswith(("running_mean",
                                                                            "running_var"))}
    sq = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grad_norms, out_grids = [], None, []
    for batch, d in zip(batches, draws):
        b = batch["frame"].shape[0]
        if rows < b:
            raise ValueError(f"the reference takes the whole batch of {b} at once "
                             f"(BatchNorm's statistics), got {rows} rows")
        with torch.no_grad():
            c = sample_numbers(batch["com"], d, vox)
            grid = grids(batch["frame"], c, m["in_size"])
            target = targets(batch["joints"], c, m["out_size"], vox["sigma"])
        out_grids.append(grid)
        for p in params.values():
            p.grad = None
        err = torch.sum((forward(params, stats, grid, tf32) - target) ** 2, dim=(2, 3, 4))
        keep = b // 2 if half_batch else b
        loss = torch.sum(err[:keep]) / (keep * err.shape[1] * target[0, 0].numel())
        loss.backward()
        alpha, eps, lr = o["alpha"], o["eps"], o["lr"]
        with torch.no_grad():
            for k, p in params.items():
                sq[k].mul_(alpha).addcmul_(p.grad, p.grad, value=1.0 - alpha)
                p.addcdiv_(p.grad, sq[k].sqrt().add_(eps), value=-lr)
        losses.append(float(loss.detach()))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(p.grad)) for k, p in params.items()}
    change = {k: float(torch.linalg.vector_norm(p.detach() - weights[k]))
              for k, p in params.items()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "grids": out_grids}
