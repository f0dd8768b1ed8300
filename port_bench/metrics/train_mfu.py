"""The whole train step's share of the card's float32 peak, in %: the
window's frames/s times 3 x the forward's FLOP a frame (arith.py), over
67 TFLOP/s."""


def read(record):
    return 100.0 * record["frames_per_s"] * 3.0 * record["flop_per_frame"] / record["peak_flops"]
