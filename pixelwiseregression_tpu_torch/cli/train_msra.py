"""Train PixelwiseRegression on one MSRA leave-one-subject-out fold (mirrors
the JAX package's root ``train_msra.py``; ``--subject`` is the held-out one).

    python -m pixelwiseregression_tpu_torch.cli.train_msra --subject 0 --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_train_parser
from pixelwiseregression_tpu_torch.cli.train_main import run_training

if __name__ == "__main__":
    args = make_train_parser(msra=True).parse_args()
    run_training(args, "MSRA", subject=args.subject)
