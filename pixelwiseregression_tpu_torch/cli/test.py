"""Batch inference on a test split -> Result/<dataset>_<suffix>.txt (mirrors
the JAX package's root ``test.py``: HAND17's 'bb' process mode and the
challenge's submission format included).

    python -m pixelwiseregression_tpu_torch.cli.test --dataset NYU --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_test_parser
from pixelwiseregression_tpu_torch.cli.test_main import run_inference

if __name__ == "__main__":
    args = make_test_parser(dataset_default="MSRA").parse_args()
    run_inference(args, args.dataset)
