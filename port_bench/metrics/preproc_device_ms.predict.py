"""Device ms a request in the letterbox + normalise (``pb.preproc``)."""


def read(d):
    if "reduced" not in d or "requests" not in d:
        return None
    s = d["reduced"]["span_s"].get("pb.preproc")
    return None if not s else s / d["requests"] * 1e3
