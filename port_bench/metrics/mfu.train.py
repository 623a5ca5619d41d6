"""The timed window's share of the card's bf16 peak: the reference model's
forward and backward FLOPs a step (``FlopCounterMode`` on the meta device)
times the steps finished, over the window's seconds, over 989 TFLOP/s."""
from port_bench.yardstick import BF16_FLOPS


def read(d):
    if "flops_per_step" not in d or not d["window_s"]:
        return None
    return 100.0 * d["flops_per_step"] * d["window_steps"] \
        / d["window_s"] / BF16_FLOPS
