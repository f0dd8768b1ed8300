"""How far a small random-weight model's uvd moves when its input frames move
by one part in a million, in f32 and in int8: the measurement behind the
int8 bounds of ``tests/test_torch_port_quant.py`` (free-running uvd against
JAX) and of ``chip_smoke.py``'s card-vs-CPU int8 check (which takes batch
norm). Not a test; runs on the CPU in about a minute:

    python tests/torch_port_int8_sensitivity.py

For the two-pass instance norm and batch norm, three static int8 coverages
and two weight seeds (NYU, 14 joints, 2 stages, features 16, level 2, f32,
three synthetic 480x640 frames): the int8 Predictor calibrates on the
frames, a second one takes its scales and predicts on the frames scaled by
1 + 1e-6. Printed, in units of the uvd scale (u and v over the crop box,
d over the cube): that int8 gap, the int8 model's own gap to its f32
model, and the f32 model's gap under the same input change.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pixelwiseregression_tpu_torch.data.sources import SPECS  # noqa: E402
from pixelwiseregression_tpu_torch.models import layers  # noqa: E402
from pixelwiseregression_tpu_torch.models.pixelwise import PixelwiseRegression  # noqa: E402
from pixelwiseregression_tpu_torch.serve import Predictor  # noqa: E402
from pixelwiseregression_tpu_torch.utils.synth import make_synthetic_raw_batch  # noqa: E402


def main():
    spec = SPECS["NYU"]
    raw = make_synthetic_raw_batch(3, spec.frame_h, spec.frame_w, spec.joint_number,
                                   fx=spec.camera.fx, fy=spec.camera.fy, cube=spec.cube_size,
                                   com_z=470.0, seed=9)
    moved = raw["frame"] * (1 + 1e-6)
    box = raw["box_size"][:, None].astype(np.float64) - 1.0
    cube = raw["cube"][:, None].astype(np.float64)

    def gap(a, b):
        d = np.abs(a - b)
        return float(max((d[..., 0] / box).max(), (d[..., 1] / box).max(),
                         (d[..., 2] / cube).max()))

    for norm in ("instance", "batch"):
        for quant in ("int8_static", "int8_static_all", "int8_static_heads"):
            for seed in (8, 9):
                torch.manual_seed(seed)
                state = PixelwiseRegression(spec.joint_number, stage=2, features=16, level=2,
                                            norm_method=norm).state_dict()
                kw = dict(batch_size=4, stages=2, features=16, level=2, norm_method=norm)
                calibrated = Predictor.from_state_dict(state, "NYU", "cpu", quant=quant,
                                                       quant_calib_batches=1, **kw)
                q = calibrated.predict(raw["frame"], raw["com"])["uvd"]
                other = Predictor.from_state_dict(state, "NYU", "cpu", quant=quant,
                                                  quant_calib_batches=0, **kw)
                layers.load_quant_scales(other.model, layers.quant_scales(calibrated.model))
                q_moved = other.predict(moved, raw["com"])["uvd"]
                f32 = Predictor.from_state_dict(state, "NYU", "cpu", **kw)
                f = f32.predict(raw["frame"], raw["com"])["uvd"]
                f_moved = f32.predict(moved, raw["com"])["uvd"]
                print(f"{norm:8s} {quant:17s} seed {seed}: int8 moved {gap(q, q_moved):.3e}, "
                      f"int8 vs f32 {gap(q, f):.3e}, f32 moved {gap(f, f_moved):.3e}")


if __name__ == "__main__":
    main()
