"""K2's share of its bandwidth roofline in the train step's backward, in
%: its bytes (no label gradient) over 3.35 TB/s, over its mean device
time a launch in the trace."""

from port_bench import arith, harness


def read(record):
    s = harness.kernel_seconds(record, "softargmax_bwd_kernel")
    if s is None:
        return None
    return arith.roofline_share(arith.k2_bytes(**record["decoder"]["k2"]), s)
