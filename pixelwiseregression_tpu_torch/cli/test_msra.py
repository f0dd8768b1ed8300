"""MSRA per-subject inference with a frames/s print (mirrors the JAX
package's root ``test_msra.py``).

    python -m pixelwiseregression_tpu_torch.cli.test_msra --subject 0 --data_path DIR
"""

from pixelwiseregression_tpu_torch.cli.common import make_test_parser
from pixelwiseregression_tpu_torch.cli.test_main import run_inference

if __name__ == "__main__":
    args = make_test_parser(msra=True).parse_args()
    run_inference(args, "MSRA", subject=args.subject)
