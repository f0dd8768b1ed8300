"""Per-layer metrics from the program's own spans
(``pixelwiseregression_tpu_torch.obs``), which it records while the traced
window's profiler runs: a span's ms over the window per root span (a train
step or a request), and the blocking copies per root span. A program
without spans, or a window without the root span, gives None."""


def _spans():
    try:
        from pixelwiseregression_tpu_torch import obs
    except ImportError:
        return []
    return obs.spans()


def ms_per_root(name: str, root: str):
    """The total ms of the spans ``name`` over the number of spans ``root``."""
    spans = _spans()
    roots = sum(s.name == root for s in spans)
    if not roots:
        return None
    return sum(s.end_ns - s.start_ns for s in spans if s.name == name) * 1e-6 / roots


def pageable_copies_per_root(record: dict, root: str):
    """The traced window's copies from or to pageable host memory (device
    records whose name holds ``Pageable``: in PyTorch eager each is followed
    by a wait on the stream) over the number of spans ``root``."""
    roots = sum(s.name == root for s in _spans())
    trace = record.get("trace")
    if not roots or trace is None:
        return None
    return sum(n for name, (_, n) in trace["kernels"].items() if "Pageable" in name) / roots
