"""Closed-loop batch prediction: one caller sends a batch of uint8
canvases, waits for its detections and OOD scores on the host, and sends
the next.

A request copies its canvases from pinned host memory to the card, runs the
port's ``batched_letterbox_normalize`` and ``DetBenchPredict.
forward_with_ood`` (forward, K2, top-k, decode, K1 soft-NMS, energy), and
ends when detections [B, 100, 6] and OOD scores [B, 100] are on the host.
The requests cycle over a pool of distinct batches made from the seed.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``pool``,
``true_side`` [lo, hi] (each image's height and width, drawn once from
``shape_seed`` and dealt to the images in an order drawn from the run's
seed), ``check_requests`` (finished requests the reference judges, one to
a pool batch),
``trace_requests`` (requests profiled in a traced run) and
``reference_block`` (images a reference forward takes at once).
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import trace as tr
from .. import yardstick as ys
from ..program import build
from ..reference import detect
from ..reference.model import EfficientDet, precision
from ..run import process_age_s
from ..weights import make_state

CHECKS = ("empty_rows", "class_err", "box_err_image", "pick_gap_mean",
          "score_err_mean", "ood_err")
# The reference judges over this many times the program's candidates: the
# anchors' best logits lie close together, and bfloat16's rounding carries
# some anchors over the program's cut that the float32 ranking puts a few
# thousand places under it; they must still be there to be matched.
JUDGED = 4


def true_sizes(traffic: Dict, seed: int) -> np.ndarray:
    """[pool, batch, 2] (h, w) of every image: one fixed multiset of sizes
    for every seed, in an order drawn from the seed."""
    lo, hi = traffic["true_side"]
    n = traffic["pool"] * traffic["batch"]
    sizes = np.random.default_rng(traffic["shape_seed"]).integers(
        lo, hi + 1, (n, 2))
    order = np.random.default_rng(seed).permutation(n)
    return sizes[order].reshape(traffic["pool"], traffic["batch"], 2)


def canvases(traffic: Dict, cfg: Dict, seed: int, device) -> torch.Tensor:
    """[pool, batch, H, W, 3] uint8 noise canvases in pinned host memory,
    drawn on ``device`` from the seed."""
    h, w = cfg["image_size"]
    g = torch.Generator(device=device).manual_seed(seed + 2)
    shape = (traffic["pool"], traffic["batch"], h, w, 3)
    host = torch.empty(shape, dtype=torch.uint8,
                       pin_memory=torch.device(device).type == "cuda")
    for j in range(traffic["pool"]):
        host[j].copy_(torch.randint(0, 256, shape[1:], generator=g,
                                    device=device, dtype=torch.uint8))
    return host


class Setup:
    """The cell's state: the reference model holding the seeded weights,
    the port's predict bench holding the same, and the traffic pool."""

    def __init__(self, run):
        from ood_object_detection_tpu_torch.data.device_preproc import \
            batched_letterbox_normalize
        self.marks = {"imports": process_age_s()}
        self.device = run.device
        self.cfg = run.config["model"]
        self.traffic = run.traffic
        self.sizes = true_sizes(self.traffic, run.seed)
        self.hw = [torch.from_numpy(s.astype(np.int32)) for s in self.sizes]
        self.pool = canvases(self.traffic, self.cfg, run.seed, self.device)
        with torch.device("meta"):
            self.ref = EfficientDet(self.cfg)
        first, _ = detect.letterbox(self.pool[0].to(self.device),
                                    self.sizes[0].tolist(),
                                    self.cfg["image_size"])
        self.state = make_state(self.ref, self.cfg, run.seed, first)
        del first
        self.marks["weights"] = process_age_s()
        self.bench = build(run.config, "predict", self.state, self.device)
        self.marks["build"] = process_age_s()
        self.letterbox = batched_letterbox_normalize
        self.spans = False
        self._hooks()

    def _hooks(self):
        """A ``pb.forward`` span around the model's forward when traced."""
        opened = []

        def pre(*_):
            if self.spans:
                opened.append(record_function("pb.forward").__enter__())

        def post(*_):
            if opened:
                opened.pop().__exit__(None, None, None)
        self.bench.model.register_forward_pre_hook(pre)
        self.bench.model.register_forward_hook(post)

    def span(self, name):
        return record_function(name) if self.spans else \
            contextlib.nullcontext()

    def request(self, i: int):
        """Request ``i``: pool batch i mod pool -> (detections, OOD) on the
        host."""
        j = i % self.traffic["pool"]
        h, w = self.cfg["image_size"]
        with self.span("pb.request"):
            with self.span("pb.h2d"):
                x = self.pool[j].to(self.device, non_blocking=True)
            with self.span("pb.preproc"):
                pre = self.letterbox(x, self.hw[j], target_hw=(h, w),
                                     out_dtype=self.cfg["compute_dtype"])
            with self.span("pb.postprocess"):
                dets, ood = self.bench.forward_with_ood(pre["image"], pre)
            with self.span("pb.d2h"):
                return dets.cpu(), ood.cpu()


def window(s: Setup, seconds: float):
    """Back-to-back requests for ``seconds``: (latencies, outputs, window
    seconds)."""
    lat, outs = [], []
    start = time.perf_counter()
    end = t = start
    while t - start < seconds:
        outs.append(s.request(len(outs)))
        end = time.perf_counter()
        lat.append(end - t)
        t = end
    return lat, outs, end - start


def sample(run, finished: int) -> List[int]:
    """The finished requests the reference judges: drawn from the seed,
    one to a pool batch, as many as ``check_requests`` and the pool
    allow."""
    order = np.random.default_rng(run.seed + 3).permutation(finished)
    pool, picked = run.traffic["pool"], {}
    for i in order.tolist():
        picked.setdefault(i % pool, i)
        if len(picked) == min(run.traffic["check_requests"], pool):
            break
    return sorted(picked.values())


def reference_candidates(s: Setup, j: int, first: int, last: int,
                         prec: str = "fp32", k: int = 0) -> detect.Candidates:
    """The reference's top ``k`` candidates (the configuration's count when
    0) of pool batch ``j``'s images [first, last): letterbox, forward and
    top-k, float32 (or ``prec``)."""
    cfg = s.cfg
    with precision(prec), torch.no_grad():
        x = s.pool[j, first:last].to(s.device)
        hw = s.sizes[j, first:last]
        images, scale = detect.letterbox(x, hw.tolist(), cfg["image_size"])
        cls_out, box_out = s.ref(images)
        anchors = torch.from_numpy(detect.anchor_boxes(cfg)).to(s.device)
        return detect.candidates(
            cls_out, box_out, anchors, cfg["num_classes"],
            k or cfg["max_detection_points"], scale,
            torch.from_numpy(hw).to(s.device))


def summarise(rows: Dict[str, torch.Tensor], empty: int) -> Dict:
    """Every served row's replay readings -> the numbers a cell may
    compare: empty rows, the share of served rows whose class is not their
    match's (``class_err``), and of each gap the widest, the 99th
    percentile, the mean and the worst image's mean (``_image``)."""
    n = len(rows["image"])
    mismatches = int(rows["class_err"].sum())
    out = {"empty_rows": empty, "rows": n, "class_mismatches": mismatches,
           "class_err": mismatches / max(n, 1),
           "images": int(rows["image"].unique().numel())}
    for k in ("box_err", "pick_gap", "score_err", "ood_err"):
        v = rows[k].double()
        if not len(v):
            out.update({f"{k}_max": 0.0, f"{k}_p99": 0.0, f"{k}_mean": 0.0,
                        f"{k}_image": 0.0})
            continue
        count = torch.bincount(rows["image"]).clamp(min=1)
        total = torch.bincount(rows["image"], weights=v)
        out.update({f"{k}_max": float(v.max()),
                    f"{k}_p99": float(torch.quantile(v, 0.99)),
                    f"{k}_mean": float(v.mean()),
                    f"{k}_image": float((total / count).max())})
    out["ood_err"] = out["ood_err_max"]
    return out


def judge(s: Setup, served: Dict[int, tuple]) -> Dict:
    """Replay each served request (request index -> (detections, OOD)) on
    its pool batch through the float32 reference: ``checks``, the numbers
    compared; ``readings``, every number ``summarise`` gives; ``judged``,
    the requests judged; and each image's reference picks by pool
    batch."""
    picks, parts, empty, first = {}, [], 0, 0
    block = s.traffic["reference_block"]
    for i, (dets, ood) in sorted(served.items()):
        j = i % s.traffic["pool"]
        picks[j] = []
        for a in range(0, s.traffic["batch"], block):
            b = min(a + block, s.traffic["batch"])
            c = reference_candidates(
                s, j, a, b, k=JUDGED * s.cfg["max_detection_points"])
            r = detect.replay(c, dets[a:b].to(s.device), ood[a:b].to(s.device))
            picks[j] += r["picks"].tolist()
            empty += int(r["empty_rows"].sum())
            r["image"] = r["image"] + first
            first += b - a
            parts.append(r)
    keys = ("image", "box_err", "pick_gap", "score_err", "class_err",
            "ood_err")
    readings = summarise({k: torch.cat([p[k] for p in parts]) for k in keys},
                         empty)
    return {"checks": {k: readings[k] for k in CHECKS}, "readings": readings,
            "judged": len(served), "picks": picks}


def control(s: Setup, requests: List[int]) -> Dict[int, tuple]:
    """The control served in the program's place: the reference in float8
    through its own soft-NMS, for the given requests."""
    served = {}
    block = s.traffic["reference_block"]
    for i in requests:
        j = i % s.traffic["pool"]
        parts = []
        for a in range(0, s.traffic["batch"], block):
            b = min(a + block, s.traffic["batch"])
            with torch.no_grad():
                parts.append(detect.soft_nms(
                    reference_candidates(s, j, a, b, "fp8"),
                    s.cfg["max_det_per_image"]))
        served[i] = (torch.cat([p[0] for p in parts]).cpu(),
                     torch.cat([p[1] for p in parts]).cpu())
    return served


def half_batch(served: Dict[int, tuple]) -> Dict[int, tuple]:
    """A fault: every request answered for its first half of images only,
    the rest of its rows empty."""
    out = {}
    for j, (dets, ood) in served.items():
        dets, ood = dets.clone(), ood.clone()
        dets[dets.shape[0] // 2:] = 0
        ood[ood.shape[0] // 2:] = 0
        out[j] = (dets, ood)
    return out


def altered(served: Dict[int, tuple]) -> Dict[int, tuple]:
    """A fault: one detection of the first request altered where it is
    produced, its box moved by its own width and its energy by 1."""
    out = dict(served)
    j = min(out)
    dets, ood = out[j][0].clone(), out[j][1].clone()
    width = dets[0, 0, 2] - dets[0, 0, 0]
    dets[0, 0, [0, 2]] += width.clamp(min=1.0)
    ood[0, 0] += 1.0
    out[j] = (dets, ood)
    return out


def class_shift(served: Dict[int, tuple]) -> Dict[int, tuple]:
    """A fault: every served class id one higher."""
    out = {}
    for j, (dets, ood) in served.items():
        dets = dets.clone()
        dets[..., 5] = torch.where(dets[..., 4] > 0, dets[..., 5] + 1,
                                   dets[..., 5])
        out[j] = (dets, ood)
    return out


def rescored(served: Dict[int, tuple]) -> Dict[int, tuple]:
    """A fault: every served score a tenth high, as a score computed
    wrong where it is produced."""
    out = {}
    for j, (dets, ood) in served.items():
        dets = dets.clone()
        dets[..., 4] *= 1.1
        out[j] = (dets, ood)
    return out


FAULTS = {"half_batch": half_batch, "altered": altered,
          "class_shift": class_shift, "rescored": rescored}


def strict_reference():
    """Float32 convolutions and matrix products without TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def run(run) -> Dict:
    s = Setup(run)
    on_card = s.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    for j in range(run.traffic["pool"]):          # every shape, once
        s.request(j)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()                       # set-up's garbage, not the window's
    setup_s = s.marks["warm_up"] = process_age_s()
    lat, outs, window_s = window(s, run.seconds)
    images = len(outs) * run.traffic["batch"]
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    served = {i: outs[i] for i in sample(run, len(outs))}

    layer: Dict = {}
    out = {"attempted": len(outs), "failed": 0, "memory_peak_bytes": peak,
           "setup_marks": s.marks,
           "end_to_end": {"predict_images_per_s": images / window_s,
                          "predict_p95_ms": float(np.percentile(lat, 95)) * 1e3,
                          "setup_s": setup_s}}
    if run.trace:
        s.spans = True
        order = [i % run.traffic["pool"] for i in served]
        events = tr.record(lambda i: s.request(order[i % len(order)]),
                           run.traffic["trace_requests"])
        s.spans = False
        red = tr.reduce(events, "pb.request")
        n = run.traffic["trace_requests"]
        layer.update(
            requests=n, reduced=red,
            flops_per_request=ys.model_flops(
                EfficientDet, s.cfg, run.traffic["batch"], train=False),
            window_requests=len(outs), window_s=window_s,
            traced_batches=[order[i % len(order)] for i in range(n)])
        out.update(busy_s=red["busy_s"], window_s=red["window_s"],
                   breakdown={"device_ops": red["device_ops"],
                              "idle_gaps": red["idle_gaps"]})
    del s.bench
    if on_card:
        torch.cuda.empty_cache()
        strict_reference()
    verdict = judge(s, served)
    out.update(checks=verdict["checks"], readings=verdict["readings"],
               judged=verdict["judged"], setup=s, served=served)
    if run.trace:
        cfg, t = s.cfg, run.traffic
        anchors = len(detect.anchor_boxes(cfg))
        k = min(cfg["max_detection_points"], anchors)
        iters = sum(ys.k1_iterations(verdict["picks"][j],
                                     cfg["max_det_per_image"])
                    for j in layer["traced_batches"])
        layer.update(
            k2_bound_s=ys.k2_bound_s(t["batch"], anchors, cfg["num_classes"]),
            k1_bound_s=ys.k1_bound_s(iters, t["batch"] * layer["requests"], k,
                                     cfg["max_det_per_image"])
            / layer["requests"])
        out["layer"] = layer
    return out
