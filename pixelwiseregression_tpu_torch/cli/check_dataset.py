"""Build and validate a dataset's index files (mirrors the JAX package's
root ``check_dataset.py``).

The host threads decode the frames; the validity check (the training
preprocess's ``valid`` flag: every joint's heatmap lands inside the label)
runs batched on the device, ``--check_batch`` samples at a time.

    python -m pixelwiseregression_tpu_torch.cli.check_dataset --dataset MSRA --data_path DIR
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from pixelwiseregression_tpu_torch.cli.common import resolve_device
from pixelwiseregression_tpu_torch.data.loader import stack_records, to_device
from pixelwiseregression_tpu_torch.data.preprocess import PreprocessConfig, preprocess_batch
from pixelwiseregression_tpu_torch.data.sources import SPECS, get_source


def make_check_fn(dataset: str, device, check_batch: int = 64):
    """``HandSource``'s ``check_fn``: records -> one bool per record, from
    ``preprocess_batch(...)["valid"]`` on ``device`` in chunks of
    ``check_batch`` (each padded to that size)."""
    spec = SPECS[dataset]
    cfg = PreprocessConfig(fx=spec.camera.fx, fy=spec.camera.fy,
                           halfu=spec.camera.halfu, halfv=spec.camera.halfv)

    def check(source, records) -> List[bool]:
        flags: List[bool] = []
        for i in range(0, len(records), check_batch):
            chunk = records[i: i + check_batch]
            batch, count = stack_records(chunk, pad_to=check_batch)
            with torch.no_grad():
                valid = preprocess_batch(to_device(batch, device), cfg)["valid"]
            flags.extend(valid[:count].cpu().numpy().astype(bool).tolist())
        return flags

    return check


def build_dataset(dataset: str, data_path: Optional[str], device, check_batch: int = 64):
    """Write the dataset's index files (if absent) with the device check."""
    return get_source(dataset, path=data_path,
                      check_fn=make_check_fn(dataset, device, check_batch))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", type=str, default="MSRA",
                        help="choose from MSRA, ICVL, NYU, HAND17")
    parser.add_argument("--data_path", type=str, default=None)
    parser.add_argument("--check_batch", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--gpu_id", type=str, default="0")
    args = parser.parse_args(argv)
    build_dataset(args.dataset, args.data_path, resolve_device(args), args.check_batch)
    print("Data ready!")


if __name__ == "__main__":
    main()
