"""The share of a request's untraced wall time in which the card ran
nothing: one less the profiled requests' busy device seconds a request
(kernels, copies and sets) over the timed window's seconds a request. The
profiler lengthens a request on the host, so its own window's idle share
would count that too."""


def read(d):
    if "requests" not in d or not d.get("window_requests"):
        return None
    busy = d["reduced"]["busy_s"] / d["requests"]
    wall = d["window_s"] / d["window_requests"]
    return 100.0 * (1.0 - busy / wall)
