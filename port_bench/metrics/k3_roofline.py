"""K3's share of its bound: the least time of the anchor match on a step's
ground truth (``yardstick.k3_bound_s``, pairs whose boxes meet counted
from the inputs) over its kernel's (``match_kernel``) device time a step."""
from port_bench.trace import kernel_seconds
from port_bench.yardstick import share


def read(d):
    if "k3_bound_s" not in d:
        return None
    t = kernel_seconds(d["reduced"], "match_kernel") / d["steps"]
    return share(d["k3_bound_s"], t)
