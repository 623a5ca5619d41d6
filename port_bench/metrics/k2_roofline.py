"""K2's share of its bound: the least time of the per-anchor key + energy
reduce on a request's logits (``yardstick.k2_bound_s``) over the device
time of its kernel (``key_energy_kernel``) a request."""
from port_bench.trace import kernel_seconds
from port_bench.yardstick import share


def read(d):
    if "k2_bound_s" not in d:
        return None
    t = kernel_seconds(d["reduced"], "key_energy_kernel") / d["requests"]
    return share(d["k2_bound_s"], t)
