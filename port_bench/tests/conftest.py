"""Shared fixtures: a copy of the benchmark at small widths, so that a
cell's whole run fits on the CPU, and the card for the ``cuda`` tests."""

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


def small_root(dst: Path, features: int = 32) -> Path:
    """``BENCHMARK.json`` and ``port_bench/`` under ``dst``, every
    configuration at ``features`` channels (at 16 the serving control's
    gap stays under its limit) and every mix at batches of 2, 2 clients and
    short traces."""
    shutil.copytree(REPO / "port_bench", dst / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "port_bench" / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["model"]["features"] = features
        f.write_text(json.dumps(c))
    for f in (dst / "port_bench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(batch=2, reference_rows=2)
        if t["driver"] == "train_step":
            t.update(trace_steps=1)
        else:
            t.update(clients=2, pool=3, warm_requests=1, trace_seconds=0.3)
        f.write_text(json.dumps(t))
    return dst


@pytest.fixture
def small(tmp_path):
    return small_root(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
