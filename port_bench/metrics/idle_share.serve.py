"""The share of the traced window in which no kernel, copy or set ran on
the card, in % (serving: the host's batching, seen from the card)."""


def read(record):
    t = record.get("trace")
    if not t or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
