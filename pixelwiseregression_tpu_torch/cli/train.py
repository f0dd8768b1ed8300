"""Train PixelwiseRegression on NYU, ICVL, HAND17 or MSRA (mirrors the JAX
package's root ``train.py``; the flags are the reference's).

    python -m pixelwiseregression_tpu_torch.cli.train --dataset NYU --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_train_parser
from pixelwiseregression_tpu_torch.cli.train_main import run_training

if __name__ == "__main__":
    args = make_train_parser(dataset_default="NYU").parse_args()
    run_training(args, args.dataset)
