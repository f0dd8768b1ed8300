"""Train V2V-PoseNet (arXiv 1711.07399) on a dataset's raw frames: each
batch voxelised on the device into 88^3 occupancy grids around the hand
centres, with the paper's augmentation (rotation U(-40, 40) degrees in the
XY plane, scale U(0.8, 1.2), shift U(-8, 8) voxels), the mean squared error
to a 3D Gaussian a joint, RMSprop at lr 2.5e-4; the val error is the
argmax decode's mean joint error in mm.

    python -m pixelwiseregression_tpu_torch.cli.train_v2v --dataset NYU --data_path DIR

The flags are ``train.py``'s; the 2D model's widths, maps and losses are
not read, and ``--using_flip`` is not: the paper flips nothing. ``--opt``
defaults to ``rmsprop``, ``--lr`` to 2.5e-4, ``--batch_size`` to the
paper's 8 and ``--lr_decay`` to 1 (a constant rate). The cube (250 mm)
and the targets' sigma (1.7 voxels) are the paper's (``VoxelConfig``);
``--in_size`` sets the input grid's side.
"""

from pixelwiseregression_tpu_torch.cli.common import make_train_parser
from pixelwiseregression_tpu_torch.cli.train_main import run_training


def make_parser():
    p = make_train_parser(suffix_default="v2v", fullregression=True)
    p.add_argument("--in_size", type=int, default=88, help="the input grid's side (voxels)")
    p.set_defaults(opt="rmsprop", lr=2.5e-4, batch_size=8, lr_decay=1.0)
    return p


if __name__ == "__main__":
    args = make_parser().parse_args()
    run_training(args, args.dataset, family="v2v")
