"""Device-busy ms a request in the traced window: the union of the
card's kernels, copies and sets over the requests answered in it."""


def read(record):
    t = record.get("trace")
    if not t or not t["busy_s"] or not record.get("requests_traced"):
        return None
    return 1e3 * t["busy_s"] / record["requests_traced"]
