"""K1's share of its bound: the least time of soft-NMS on a request's
candidates, its iterations counted from the reference's picks
(``yardstick.k1_bound_s``), over its kernel's (``nms_kernel``) device time
a request."""
from port_bench.trace import kernel_seconds
from port_bench.yardstick import share


def read(d):
    if "k1_bound_s" not in d:
        return None
    t = kernel_seconds(d["reduced"], "nms_kernel") / d["requests"]
    return share(d["k1_bound_s"], t)
