"""Device ms a request in the model's forward (``pb.forward``, opened by
hooks on the predict bench's model)."""


def read(d):
    if "reduced" not in d or "requests" not in d:
        return None
    s = d["reduced"]["span_s"].get("pb.forward")
    return None if not s else s / d["requests"] * 1e3
