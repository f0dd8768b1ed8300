"""Train the FullRegression ablation: direct regression, the uvd loss alone
(mirrors the JAX package's root ``train_fullregression.py``; the flags are
the reference's).

    python -m pixelwiseregression_tpu_torch.cli.train_fullregression --dataset NYU --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_train_parser
from pixelwiseregression_tpu_torch.cli.train_main import run_training

if __name__ == "__main__":
    args = make_train_parser(suffix_default="full_regression", fullregression=True).parse_args()
    run_training(args, args.dataset, family="fullregression")
