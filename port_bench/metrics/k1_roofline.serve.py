"""K1's share of its bandwidth roofline in a serving call, in %: its bytes
at the request's shape over 3.35 TB/s, over its mean device time a
launch in the trace."""

from port_bench import arith, harness


def read(record):
    s = harness.kernel_seconds(record, "softargmax_fwd_kernel")
    if s is None:
        return None
    return arith.roofline_share(arith.k1_bytes(**record["decoder"]["k1"]), s)
