"""Host ms a request spends launching the serving function
(``serve.ServingFunction``: the span ``serve.launch``), over the traced
window's ``serve.predict`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("serve.launch", "serve.predict")
