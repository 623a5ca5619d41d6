"""K4's share of its bound: the least time of the match codes and targets
(``yardstick.k4_bound_s``, positives from the reference labeler) over its
kernel's (``codes_targets_kernel``) device time a step."""
from port_bench.trace import kernel_seconds
from port_bench.yardstick import share


def read(d):
    if "k4_bound_s" not in d:
        return None
    t = kernel_seconds(d["reduced"], "codes_targets_kernel") / d["steps"]
    return share(d["k4_bound_s"], t)
