"""Closed-loop training: the port's train step (``create_train_state``,
then ``make_train_step(..., freeze_bn='backbone')``: K3 -> K4 labeling,
forward, focal + huber loss, backward, clipped SGD, EMA) run back to back
over a pool of batches resident on the card.

Set-up builds the one step and its state, and drives it through its first
three steps on three different batches of the pool; those steps are also
the warm-up, and the window continues from them. The reference follows
the same three steps from the same weights, after the window.

Traffic parameters (``traffic/<name>.json``): ``batch``, ``pool``,
``rows`` (ground-truth rows an image, padded), ``boxes_lognormal``
[mu, sigma] (boxes an image: a lognormal draw, rounded, clipped to
[1, rows], one fixed multiset from ``shape_seed`` dealt in an order drawn
from the run's seed), ``box_side`` [lo, hi] (pixels, log-uniform),
``checked_steps`` (steps the reference follows) and ``trace_steps``.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch
from torch.autograd.profiler import record_function

from .. import trace as tr
from .. import yardstick as ys
from ..program import build
from ..reference import train as ref_train
from ..reference.detect import anchor_boxes
from ..reference.model import EfficientDet, precision
from ..run import process_age_s
from ..weights import make_state

CHECKS = ("loss_gap", "grad_gap", "change_gap", "ema_gap", "grad_gap_median",
          "change_gap_median")


def box_counts(traffic: Dict, seed: int) -> np.ndarray:
    """[pool, batch] boxes of every image: one fixed multiset for every
    seed, in an order drawn from the seed."""
    mu, sigma = traffic["boxes_lognormal"]
    n = traffic["pool"] * traffic["batch"]
    counts = np.clip(np.rint(np.random.default_rng(traffic["shape_seed"])
                             .lognormal(mu, sigma, n)), 1, traffic["rows"])
    order = np.random.default_rng(seed).permutation(n)
    return counts[order].astype(np.int64).reshape(traffic["pool"], -1)


def batches(traffic: Dict, cfg: Dict, seed: int, device) -> List[Dict]:
    """The pool: normal images [B, H, W, 3] f32 and padded ground truth
    ('bbox' [B, rows, 4] yxyx pixels, 'cls' [B, rows] 1-based, -1 padding),
    drawn on ``device`` from the seed."""
    h, w = cfg["image_size"]
    b, rows = traffic["batch"], traffic["rows"]
    lo, hi = np.log(traffic["box_side"][0]), np.log(traffic["box_side"][1])
    g = torch.Generator(device=device).manual_seed(seed + 4)
    counts = torch.from_numpy(box_counts(traffic, seed)).to(device)
    pool = []
    for j in range(traffic["pool"]):
        u = torch.rand((b, rows, 4), generator=g, device=device)
        side = torch.exp(lo + (hi - lo) * u[..., :2])
        side = torch.minimum(side, torch.tensor([h, w], device=device))
        corner = u[..., 2:] * (torch.tensor([h, w], device=device) - side)
        boxes = torch.cat([corner, corner + side], -1)
        cls = torch.randint(1, cfg["num_classes"] + 1, (b, rows), generator=g,
                            device=device, dtype=torch.int32)
        valid = torch.arange(rows, device=device)[None] < counts[j][:, None]
        pool.append({
            "image": torch.randn((b, h, w, 3), generator=g, device=device),
            "bbox": torch.where(valid[..., None], boxes, 0.0),
            "cls": torch.where(valid, cls, -1)})
    return pool


def params_of(model) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep) -> np.ndarray:
    """Each kept leaf's gap of norms, |norm(got) - norm(want)|, over the
    larger of that leaf's reference norm and the median leaf's."""
    norms = {k: float(v.double().norm()) for k, v in want.items() if keep(k)}
    median = float(np.median(list(norms.values())))
    return np.array([abs(float(got[k].double().norm()) - n) / max(n, median)
                     for k, n in norms.items()])


def compare(program: Dict, reference: Dict, grad_floor: float = 1e-3
            ) -> Dict[str, float]:
    """The numbers compared: the worst step's loss gap over the
    reference's loss; the worst leaf's and the median leaf's gap of the
    first gradient (as the optimizer took it) and of the change of the
    parameters over the checked steps; the worst leaf's gap of the EMA's
    change. Leaves whose reference gradient is under ``grad_floor`` of the
    median leaf's move by round-off alone and are left out of the changes
    (squeeze-excite convolutions of the frozen backbone, whose gradient
    through a gate of random weights is nought)."""
    g_ref = reference["grad"]
    norms = {k: float(v.double().norm()) for k, v in g_ref.items()}
    floor = grad_floor * float(np.median(list(norms.values())))
    moved = lambda k: norms[k] >= floor
    delta = lambda side, key: {k: side[key][k] - side["start"][k]
                               for k in side["start"]}
    grad = leaf_gaps(program["grad"], g_ref, lambda k: True)
    change = leaf_gaps(delta(program, "params"), delta(reference, "params"),
                       moved)
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(program["losses"], reference["losses"])),
        "grad_gap": float(grad.max()),
        "change_gap": float(change.max()),
        "ema_gap": float(leaf_gaps(delta(program, "ema"),
                                   delta(reference, "ema"), moved).max()),
        "grad_gap_median": float(np.median(grad)),
        "change_gap_median": float(np.median(change)),
    }


def reference_steps(model, cfg: Dict, tcfg: Dict, state: Dict, pool: List,
                    steps: int, device, prec: str = "fp32") -> Dict:
    """The reference's first ``steps`` steps from ``state``."""
    model.load_state_dict(state)
    start = params_of(model)
    anchors = torch.from_numpy(anchor_boxes(cfg)).to(device)
    with precision(prec):
        losses, grad, params, ema = ref_train.train_steps(
            model, cfg, pool[:steps], anchors, tcfg)
    return {"losses": losses, "grad": grad, "params": params, "ema": ema,
            "start": start}


class Setup:
    def __init__(self, run):
        from ood_object_detection_tpu_torch.config import \
            default_detection_train_config
        from ood_object_detection_tpu_torch.train import (
            cosine_lr_schedule, create_train_state, make_train_step)
        self.marks = {"imports": process_age_s()}
        self.device = run.device
        self.cfg = run.config["model"]
        self.pool = batches(run.traffic, self.cfg, run.seed, self.device)
        with torch.device("meta"):
            self.ref = EfficientDet(self.cfg)
        self.state = make_state(self.ref, self.cfg, run.seed,
                                self.pool[0]["image"])
        self.marks["weights"] = process_age_s()
        self.bench = build(run.config, "train", self.state, self.device)
        self.marks["build"] = process_age_s()
        tcfg = default_detection_train_config()
        self.tcfg = {k: getattr(tcfg, k) for k in
                     ("lr", "momentum", "clip_grad_norm", "ema_decay",
                      "warmup_lr", "warmup_epochs")}
        self.tcfg["steps_per_epoch"] = run.traffic["steps_per_epoch"]
        # the configuration's schedule (cosine after a linear warm-up), as
        # the pretrain driver runs it: at a constant 0.09 from step 0 the
        # seeded weights diverge within some tens of steps
        self.train_state, self.tx = create_train_state(
            self.bench, tcfg, cosine_lr_schedule(
                tcfg, run.traffic["steps_per_epoch"]))
        self.step = make_train_step(self.bench, self.tx, self.bench.anchors,
                                    tcfg, freeze_bn="backbone")
        self.metrics = []

    def train(self, i: int):
        with torch.enable_grad():
            _, m = self.step(self.train_state,
                             self.pool[i % len(self.pool)])
        self.metrics.append(m)

    def first_steps(self, n: int) -> Dict:
        """Steps 1..n through the window's call, with what the reference
        compares: each loss, the first gradient as the optimizer took it
        (its momentum buffer after step 1), the parameters and the EMA
        after step n, and the parameters before step 1."""
        model = self.train_state.model
        start = params_of(model)
        grad = None
        for i in range(n):
            self.train(i)
            if i == 0:         # a step that moved nothing left no buffer
                grad = {k: self.tx.state.get(p, {}).get(
                    "momentum_buffer", torch.zeros_like(p)).clone()
                    for k, p in model.named_parameters()}
        return {"losses": [float(m["loss"]) for m in self.metrics[:n]],
                "grad": grad, "params": params_of(model),
                "ema": {k: v.clone() for k, v in
                        self.train_state.ema_params.items()},
                "start": start}


def run(run) -> Dict:
    s = Setup(run)
    on_card = s.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_check = run.traffic["checked_steps"]
    program = s.first_steps(n_check)
    sync()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()                       # set-up's garbage, not the window's
    setup_s = s.marks["warm_up"] = process_age_s()
    steps = 0
    start = time.perf_counter()
    while time.perf_counter() - start < run.seconds:
        s.train(n_check + steps)
        steps += 1
    sync()
    window_s = time.perf_counter() - start
    failed = sum(not bool(torch.isfinite(m["loss"]))
                 for m in s.metrics[n_check:])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    b = run.traffic["batch"]
    out = {"attempted": steps, "failed": failed, "memory_peak_bytes": peak,
           "setup_marks": s.marks,
           "end_to_end": {"train_images_per_s": steps * b / window_s,
                          "setup_s": setup_s}}
    layer: Dict = {}
    if run.trace:
        n = run.traffic["trace_steps"]
        events = tr.record(lambda i: _traced_step(s, i), n)
        red = tr.reduce(events, "pb.step")
        layer.update(steps=n, reduced=red, window_steps=steps,
                     window_s=window_s,
                     flops_per_step=ys.model_flops(EfficientDet, s.cfg, b,
                                                   train=True))
        out.update(busy_s=red["busy_s"], window_s=red["window_s"],
                   breakdown={"device_ops": red["device_ops"],
                              "idle_gaps": red["idle_gaps"]})
        _labeler_bounds(s, layer, n)
    pool = s.pool
    del s.bench, s.step, s.train_state, s.tx, s.metrics
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    reference = reference_steps(s.ref, s.cfg, s.tcfg, s.state, pool, n_check,
                                s.device)
    out["checks"] = compare(program, reference)
    out["layer"] = layer
    return out


def _traced_step(s: Setup, i: int) -> None:
    with record_function("pb.step"):
        s.train(i)


def _labeler_bounds(s: Setup, layer: Dict, n: int) -> None:
    """K3's and K4's bounds for the traced steps' batches, their work
    counted from the inputs and the reference labeler."""
    anchors = torch.from_numpy(anchor_boxes(s.cfg)).to(s.device)
    k3 = k4 = 0.0
    for i in range(n):
        batch = s.pool[i % len(s.pool)]
        valid = batch["cls"] > -1
        b, rows = valid.shape
        meets = ys.meeting_pairs(anchors, batch["bbox"], valid)
        k3 += ys.k3_bound_s(len(anchors), b, rows, int(valid.sum()), meets)
        _, _, match, _ = ref_train.label(anchors, batch["bbox"], batch["cls"])
        k4 += ys.k4_bound_s(len(anchors), b, rows, int((match >= 0).sum()))
    layer.update(k3_bound_s=k3 / n, k4_bound_s=k4 / n)
