"""The share of a step's untraced wall time in which the card ran
nothing: one less the profiled steps' busy device seconds a step (kernels,
copies and sets) over the timed window's seconds a step. The profiler
lengthens a step on the host, so its own window's idle share would count
that too."""


def read(d):
    if "steps" not in d or not d.get("window_steps"):
        return None
    busy = d["reduced"]["busy_s"] / d["steps"]
    wall = d["window_s"] / d["window_steps"]
    return 100.0 * (1.0 - busy / wall)
