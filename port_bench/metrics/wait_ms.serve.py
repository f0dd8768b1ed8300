"""Host ms a request spends waiting for its answers on the host (the
``.cpu()`` gather: the span ``serve.wait``), over the traced window's
``serve.predict`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("serve.wait", "serve.predict")
