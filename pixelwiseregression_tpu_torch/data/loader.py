"""Host-side batching and prefetching (mirrors ``pixelwiseregression_tpu/data/loader.py``).

A numpy copy of the JAX module's ``stack_records`` and ``Loader``: a thread
pool decodes samples (PNG/zlib decoding and the native decoders release the
GIL) while the device works on the previous batch, and up to four ready
batches are buffered. It yields numpy batches, the same batches in the same
order as the JAX ``Loader`` for the same seed; ``to_device`` moves one to
the card from pinned host memory.

Fixed shapes: with ``drop_last=False`` the final partial batch is padded by
repeating its last sample, and a ``count`` field carries the number of real
samples, a ``weight`` field marks them (1 real, 0 pad).
"""

from __future__ import annotations

import queue
import random
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from pixelwiseregression_tpu_torch import obs


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


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``. For a CUDA device each array
    is copied into pinned host memory and sent with a non-blocking copy on
    the current stream (the caching host allocator keeps the pinned buffer
    until the copy is done). While a profiler runs, the call is the span
    ``loader.to_device`` (``obs``)."""
    device = torch.device(device)
    out = {}
    with obs.span("loader.to_device"):
        for k, v in batch.items():
            t = torch.from_numpy(np.require(v, requirements="C"))
            out[k] = t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t
    return out


class Loader:
    def __init__(
        self,
        source,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        seed: int = 0,
        lines: Optional[List[str]] = None,
        on_error: str = "raise",
    ):
        """``on_error``: 'raise' (default — reference-compatible: train/val
        index lists are pre-filtered by the dataset check, so a decode
        failure is a real bug) or 'skip' (warn and drop the sample — for
        unfiltered test/serving inputs where one corrupt file must not kill
        the run; reference test lists are never validity-checked,
        datasets.py:467-469)."""
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
        self.source = source
        self.lines = list(lines if lines is not None else source.lines)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.on_error = on_error
        self._rng = random.Random(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.lines)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def num_samples(self) -> int:
        return len(self.lines)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = list(range(len(self.lines)))
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1

        bs = self.batch_size
        batches = [order[i : i + bs] for i in range(0, len(order), bs)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == bs]

        out_q: "queue.Queue" = queue.Queue(maxsize=4)
        sentinel = object()
        # set when the consumer stops early, so that the producer thread
        # does not wait forever on a full queue
        stopped = threading.Event()

        def put(item):
            while not stopped.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        batch_fn = getattr(self.source, "batch_records", None)

        def record_or_skip(i):
            try:
                return self.source.record(self.lines[i])
            except Exception as e:
                if self.on_error == "skip":
                    warnings.warn(
                        f"skipping undecodable sample {self.lines[i]!r}: "
                        f"{type(e).__name__}: {e}"
                    )
                    return None
                raise

        # skip mode must preserve POSITIONS: result rows are matched to the
        # test list (and HAND17 submission image names) by index, so a bad
        # sample is replaced by a placeholder copy of a good record and
        # reported via the batch's `decode_ok` mask — never silently dropped
        # (which would shift every following row onto the wrong frame).
        last_good = [None]

        def produce():
            # skip mode: a run of LEADING all-bad batches has no good record
            # to build placeholders from yet — buffer them (in order) and
            # flush once the first decodable sample appears. Emission order
            # is preserved, so result-row positions stay aligned.
            pending: list[tuple[list, list]] = []

            def emit(recs, ok):
                batch, count = stack_records(recs, pad_to=bs)
                batch["count"] = np.int32(count)
                if self.on_error == "skip":
                    batch["decode_ok"] = np.asarray(
                        ok + [True] * (bs - count), np.bool_
                    )
                put(batch)

            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stopped.is_set():
                            return
                        ok = None
                        if batch_fn is not None and self.on_error != "skip":
                            # native (GIL-free, internally threaded) batch decode
                            recs = batch_fn([self.lines[i] for i in idxs])
                        else:
                            if batch_fn is not None:
                                try:
                                    recs = batch_fn([self.lines[i] for i in idxs])
                                except Exception:
                                    recs = list(pool.map(record_or_skip, idxs))
                            else:
                                recs = list(pool.map(record_or_skip, idxs))
                            ok = [r is not None for r in recs]
                            good = next((r for r in recs if r is not None), None)
                            if good is not None:
                                last_good[0] = good
                            elif last_good[0] is None:
                                pending.append((recs, ok))
                                continue
                            for held_recs, held_ok in pending:
                                emit([last_good[0]] * len(held_recs), held_ok)
                            pending.clear()
                            recs = [r if r is not None else last_good[0] for r in recs]
                        emit(recs, ok)
                    if pending:  # every sample in the dataset failed to decode
                        raise RuntimeError(
                            f"no decodable sample in the entire dataset "
                            f"({len(pending)} all-bad batches buffered); "
                            "cannot build placeholder records"
                        )
            except BaseException as e:  # surface decode failures to the consumer
                put(e)
            finally:
                put(sentinel)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stopped.set()
