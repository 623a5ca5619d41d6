"""Device ms a request in the post-process: what ``forward_with_ood``
launches outside the model's forward (K2, top-k, decode, K1, energy)."""


def read(d):
    if "reduced" not in d or "requests" not in d:
        return None
    s = d["reduced"]["span_s"].get("pb.postprocess")
    return None if not s else s / d["requests"] * 1e3
