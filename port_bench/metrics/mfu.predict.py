"""The timed window's share of the card's bf16 peak: the reference model's
forward FLOPs a request (``FlopCounterMode`` on the meta device) times the
requests finished, over the window's seconds, over 989 TFLOP/s."""
from port_bench.yardstick import BF16_FLOPS


def read(d):
    if "flops_per_request" not in d or not d["window_s"]:
        return None
    return 100.0 * d["flops_per_request"] * d["window_requests"] \
        / d["window_s"] / BF16_FLOPS
