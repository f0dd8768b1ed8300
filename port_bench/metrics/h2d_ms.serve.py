"""Host ms a request spends copying its batch to the card
(``serve_artifact._device_batch``, pageable: the span ``serve.to_device``),
over the traced window's ``serve.predict`` spans."""

from port_bench import spans


def read(record):
    return spans.ms_per_root("serve.to_device", "serve.predict")
