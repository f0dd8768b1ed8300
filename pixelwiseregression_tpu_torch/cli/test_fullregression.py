"""Inference for the FullRegression ablation -> Result/<dataset>_full_regression.txt
(mirrors the JAX package's root ``test_fullregression.py``).

    python -m pixelwiseregression_tpu_torch.cli.test_fullregression --dataset NYU --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_test_parser
from pixelwiseregression_tpu_torch.cli.test_main import run_inference

if __name__ == "__main__":
    args = make_test_parser(dataset_default="NYU", fullregression=True).parse_args()
    run_inference(args, args.dataset, fullregression=True)
