"""Host batching (mirrors ``stack_records`` of ``pixelwiseregression_tpu/data/loader.py``).

The threaded prefetching ``Loader`` comes with the training port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def stack_records(records: List[Dict[str, np.ndarray]], pad_to: Optional[int] = None):
    """Stack per-sample host records into a batch; optionally pad by
    repeating the final record. Adds a ``weight`` field (1 = real sample,
    0 = pad). Returns (batch, count)."""
    count = len(records)
    total = pad_to if pad_to is not None and count < pad_to else count
    if total > count:
        records = records + [records[-1]] * (total - count)
    keys = records[0].keys()
    batch = {k: np.stack([r[k] for r in records]) for k in keys}
    batch["weight"] = (np.arange(total) < count).astype(np.float32)
    return batch, count
