"""Host ms a request spends building its padded batch
(``serve_artifact._build_batch``: the span ``serve.build_batch``), over the
traced window's ``serve.predict`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("serve.build_batch", "serve.predict")
