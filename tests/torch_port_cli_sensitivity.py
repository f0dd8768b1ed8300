"""How far two runs of the train CLI part on the MSRA fixture when they
start one rounding apart: the measurement behind the learning rate of
``tests/test_torch_port_cli.py``'s resumed epoch. Not a test; run on the CPU
(~10 min):

    JAX_PLATFORMS=cpu python tests/torch_port_cli_sensitivity.py

For one and two stages, the JAX CLI trains one epoch (lr 1e-3, Adam or SGD)
and saves a ``.ckpt``. From it, for each resumed learning rate, one more
epoch runs three ways: the JAX CLI, the JAX CLI from the same checkpoint
with every param scaled by 1 +- 1e-7 (a random sign each), and the port's
CLI. Printed: each run's train loss and val mean-mm per stage, their
relative gaps to the JAX run, and the params' largest gap to the JAX run's
and the share of their elements outside rtol 1e-4 atol 1e-6, over the
params whose gradient is not zero by design.
"""

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
from flax import serialization  # noqa: E402

import test_torch_port_cli as t  # noqa: E402
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression  # noqa: E402
from pixelwiseregression_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402


def _param_gaps(got: str, want: str, stages: int):
    """(largest gap, share outside rtol 1e-4 atol 1e-6) over the params whose
    gradient is not zero by design."""
    model = PixelwiseRegression(21, stage=stages, features=t.SMALL["features"],
                                level=t.SMALL["level"], norm_method="instance_anchored")
    skip = t._zero_gradient_params(model)
    g, w = load_checkpoint(got)["state_dict"], load_checkpoint(want)["state_dict"]
    gap, out, n = 0.0, 0, 0
    for name, _ in model.named_parameters():
        if name in skip:
            continue
        a, b = g[name].numpy().astype(np.float64), w[name].numpy().astype(np.float64)
        gap = max(gap, float(np.abs(a - b).max()))
        out += int((np.abs(a - b) > 1e-4 * np.abs(b) + 1e-6).sum())
        n += a.size
    return gap, out / n


def _perturbed(ckpt: str, out: str):
    """The checkpoint with every param scaled by 1 +- 1e-7."""
    with open(ckpt, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    rng = np.random.RandomState(0)
    params = serialization.msgpack_restore(payload["params"])
    params = jax.tree_util.tree_map(
        lambda a: (a * (1 + 1e-7 * rng.choice([-1, 1], a.shape))).astype(a.dtype), params)
    payload["params"] = serialization.msgpack_serialize(params)
    with open(out, "wb") as f:
        f.write(serialization.msgpack_serialize(payload))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--opts", default="adam,sgd")
    p.add_argument("--lrs", default="1e-3,1e-5")
    p.add_argument("--stages", default="1,2")
    a = p.parse_args()
    os.environ["PWR_TB_IMAGES"] = "0"
    base = tempfile.mkdtemp()
    root = os.path.join(base, "msra")
    import subprocess

    subprocess.run([sys.executable, t.FIXTURE, root], check=True, capture_output=True)
    for stages in (int(x) for x in a.stages.split(",")):
        for opt in a.opts.split(","):
            kw = dict(opt=opt, stages=stages)
            first = os.path.join(base, f"first_{opt}_{stages}")
            t._in_dir(first, t.jax_training, t._cli_args(root, **kw), "MSRA", subject=0)
            ckpt = os.path.join(first, "Model", "MSRA_par_subject0_0.ckpt")
            pert = os.path.join(first, "perturbed.ckpt")
            _perturbed(ckpt, pert)
            for lr in (float(x) for x in a.lrs.split(",")):
                runs, saved = {}, {}
                for name, fn, start, decoder, ext in (
                        ("jax", t.jax_training, ckpt, "xla", ".ckpt"),
                        ("jax 1e-7", t.jax_training, pert, "xla", ".ckpt"),
                        ("port", t.port_training, ckpt, "cuda", ".pt")):
                    d = os.path.join(base, f"{opt}_{stages}_{lr}_{name.replace(' ', '_')}")
                    _, text = t._in_dir(d, fn, t._cli_args(root, lr=lr, resume=start,
                                                           decoder=decoder, **kw),
                                        "MSRA", subject=0)
                    runs[name] = t._epoch_line(text)
                    saved[name] = os.path.join(d, "Model", "MSRA_par_subject0_0" + ext)
                jloss, jmm = runs["jax"]
                for name, (loss, mm) in runs.items():
                    gap, share = _param_gaps(saved[name], saved["jax"], stages)
                    print(f"stages {stages} {opt} resumed lr {lr:g} {name:>8}: train_loss "
                          f"{loss:.5f} val mean-mm {mm}  gaps to jax: loss "
                          f"{abs(loss - jloss) / jloss:.2e}, mean-mm "
                          f"{np.abs(mm - jmm).max() / jmm.max():.2e}, params {gap:.2e} "
                          f"({share:.2%} outside rtol 1e-4 atol 1e-6)", flush=True)


if __name__ == "__main__":
    main()
