"""The whole serving call's share of the card's float32 peak, in %: the
window's frames/s times the forward's FLOP a frame (arith.py), over
67 TFLOP/s."""


def read(record):
    return 100.0 * record["frames_per_s"] * record["flop_per_frame"] / record["peak_flops"]
