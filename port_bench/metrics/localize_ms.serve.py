"""Host ms a request spends queuing the localisation of its frames from
their boxes and their crop integers on the device (``ops.localize``: the
span ``serve.localize``), over the traced window's ``serve.predict``
spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("serve.localize", "serve.predict")
