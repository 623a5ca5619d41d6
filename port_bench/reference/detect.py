"""The plain predict path after the forward, and the judge of the
program's detections: letterbox, anchors, box decoding, per-anchor top-k,
energy, gaussian soft-NMS, and the replay that holds each detection the
program served against the reference's own state at that pick.

Conventions of the published EfficientDet post-process (effdet): anchors
yxyx, cell-major then (octave, aspect) within a level; box codes
(ty, tx, th, tw); scores are the sigmoid of each anchor's best class
logit, kept when above 0.01; soft-NMS per class with gaussian decay
exp(-iou^2 / 0.5), scores at or under 0.001 pruned, 100 picks; rows
[x1, y1, x2, y2, score, class + 1] in the original image's pixels.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

MIN_SCORE = 0.01
SIGMA = 0.5
PRUNE = 0.001
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
FILL = (124.0, 116.0, 104.0)


def letterbox(canvases: torch.Tensor, true_hw: Sequence[Sequence[int]],
              size: Sequence[int]):
    """uint8 canvases [B, Hc, Wc, 3] whose top-left (h, w) is the image ->
    (normalised float32 images [B, H, W, 3], scale [B] original / target).
    Each image is resized by s = min(H / h, W / w) with bilinear sampling
    at half-pixel centres over the whole canvas (its edge pixels repeated),
    to floor(h s) x floor(w s); the rest is the fill colour; then ImageNet
    normalisation."""
    th, tw = size
    dev = canvases.device
    out = torch.tensor(FILL, device=dev).expand(len(true_hw), th, tw, 3) \
        .clone()
    scales = []
    for i, (h, w) in enumerate(true_hw):
        s = min(np.float32(th) / np.float32(h), np.float32(tw) / np.float32(w))
        sh, sw = int(np.floor(np.float32(h) * s)), int(np.floor(np.float32(w) * s))
        img = canvases[i].float()      # samples may reach past (h, w)
        out[i, :sh, :sw] = _bilinear(_bilinear(img, sh, float(s), 0), sw,
                                     float(s), 1)
        scales.append(1.0 / float(s))
    mean = torch.tensor(MEAN, device=dev) * 255.0
    std = torch.tensor(STD, device=dev) * 255.0
    return (out - mean) / std, torch.tensor(scales, device=dev)


def _bilinear(img: torch.Tensor, n: int, s: float, axis: int) -> torch.Tensor:
    size = img.shape[axis]
    x = (torch.arange(n, device=img.device, dtype=torch.float64) + 0.5) / s \
        - 0.5
    x = x.clamp(0, size - 1)
    lo = x.floor().long()
    hi = (lo + 1).clamp(max=size - 1)
    frac = (x - lo).float()
    shape = [1, 1, 1]
    shape[axis] = n
    frac = frac.view(shape)
    a, b = img.index_select(axis, lo), img.index_select(axis, hi)
    return a * (1 - frac) + b * frac


def anchor_boxes(cfg: Dict) -> np.ndarray:
    """[A, 4] yxyx anchors of every level, float32."""
    h, w = cfg["image_size"]
    out = []
    for level in range(cfg["min_level"], cfg["max_level"] + 1):
        fh, fw = h, w
        for _ in range(level):
            fh, fw = (fh - 1) // 2 + 1, (fw - 1) // 2 + 1
        sy, sx = h // fh, w // fw
        yc, xc = np.meshgrid(np.arange(sy / 2.0, h, sy),
                             np.arange(sx / 2.0, w, sx), indexing="ij")
        per = []
        for octave in range(cfg["num_scales"]):
            for ax, ay in cfg["aspect_ratios"]:
                base = cfg["anchor_scale"] * 2.0 ** (octave / cfg["num_scales"])
                hy, hx = base * sy * ay / 2.0, base * sx * ax / 2.0
                per.append(np.stack([yc - hy, xc - hx, yc + hy, xc + hx],
                                    -1).reshape(-1, 4))
        out.append(np.stack(per, 1).reshape(-1, 4))
    return np.concatenate(out).astype(np.float32)


def decode(codes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """(ty, tx, th, tw) codes against yxyx anchors -> xyxy boxes."""
    ha, wa = anchors[..., 2] - anchors[..., 0], anchors[..., 3] - anchors[..., 1]
    yc, xc = anchors[..., 0] + ha / 2, anchors[..., 1] + wa / 2
    y = codes[..., 0] * ha + yc
    x = codes[..., 1] * wa + xc
    h, w = torch.exp(codes[..., 2]) * ha, torch.exp(codes[..., 3]) * wa
    return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)


class Candidates(NamedTuple):
    """The top-k anchors of each image: boxes xyxy in original pixels
    [B, K, 4], scores [B, K] (0 at or under the floor), classes [B, K],
    energies [B, K] (logsumexp of the anchor's class logits)."""
    boxes: torch.Tensor
    scores: torch.Tensor
    classes: torch.Tensor
    energy: torch.Tensor


def candidates(cls_levels: List[torch.Tensor], box_levels: List[torch.Tensor],
               anchors: torch.Tensor, num_classes: int, k: int,
               scale: torch.Tensor, true_hw: torch.Tensor) -> Candidates:
    """Per-level NHWC head outputs of a batch -> its candidates."""
    b = cls_levels[0].shape[0]
    logits = torch.cat([c.reshape(b, -1, num_classes) for c in cls_levels],
                       1).float()
    codes = torch.cat([c.reshape(b, -1, 4) for c in box_levels], 1).float()
    best, cls = logits.max(-1)
    idx = torch.sort(best, dim=1, descending=True, stable=True)[1][:, :k]
    best = best.gather(1, idx)
    boxes = decode(codes.gather(1, idx[..., None].expand(-1, -1, 4)),
                   anchors[idx])
    # clip to the image's letterboxed extent, then back to its pixels
    limit = (true_hw.float() / scale[:, None]).flip(-1)        # [B, (w, h)]
    boxes = torch.minimum(boxes.clamp(min=0), limit.repeat(1, 2)[:, None])
    boxes = boxes * scale[:, None, None]
    scores = torch.sigmoid(best)
    scores = torch.where(scores > MIN_SCORE, scores, torch.zeros_like(scores))
    energy = torch.logsumexp(logits.gather(
        1, idx[..., None].expand(-1, -1, num_classes)), -1)
    return Candidates(boxes, scores, cls.gather(1, idx), energy)


def iou(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of [B, 4] xyxy boxes with [B, K, 4]; 0 where they do not meet."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    area = lambda t: (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    union = area(box)[:, None] + area(boxes) - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def _decay(c: Candidates, scores: torch.Tensor, pick: torch.Tensor,
           cls: torch.Tensor) -> torch.Tensor:
    """Decay the candidates of class ``cls`` [B] by their IoU with
    ``pick``, and drop ``pick``."""
    rows = torch.arange(scores.shape[0], device=scores.device)
    same = c.classes == cls[:, None]
    o = iou(c.boxes[rows, pick], c.boxes) * same
    scores = scores * torch.exp(-(o * o) / SIGMA)
    scores[rows, pick] = 0.0
    return torch.where(scores > PRUNE, scores, torch.zeros_like(scores))


def soft_nms(c: Candidates, max_out: int = 100):
    """Greedy gaussian soft-NMS per class -> (detections [B, max_out, 6],
    energies [B, max_out]); each pick keeps its score at the pick."""
    b = c.scores.shape[0]
    rows = torch.arange(b, device=c.scores.device)
    scores = c.scores.clone()
    dets = torch.zeros((b, max_out, 6), device=scores.device)
    ood = torch.zeros((b, max_out), device=scores.device)
    for t in range(max_out):
        top = scores.argmax(1)
        s = scores[rows, top]
        live = (s > 0)[:, None]
        row = torch.cat([c.boxes[rows, top], s[:, None],
                         c.classes[rows, top, None].float() + 1], -1)
        dets[:, t] = torch.where(live, row, torch.zeros_like(row))
        ood[:, t] = torch.where(live[:, 0], c.energy[rows, top],
                                torch.zeros_like(s))
        scores = _decay(c, scores, top, c.classes[rows, top])
    return dets, ood


def replay(c: Candidates, dets: torch.Tensor, ood: torch.Tensor
           ) -> Dict[str, torch.Tensor]:
    """Follow the served detections pick by pick through the reference's
    soft-NMS on its own candidates. At each pick the served row is matched
    to the live reference candidate nearest in box (L-infinity), which is
    the same anchor where the two agree; boxes that coincide, as clipped
    ones can, are told apart by class, then by score. The reference then
    decays the candidates of the served class by that candidate, as the
    program did by its pick. Returns, for each served row (flattened; its
    image named by ``image``):
      image: the row's image;
      box_err: its distance from its match over the match's longer side
        (1e9 where the reference had no candidate left);
      pick_gap: how far the match's score lies under the reference's best
        live score at that pick, over that best (0 where it is the best);
      score_err: |served score - the match's decayed score| over the
        latter;
      class_err: 1 where the served class is not the match's;
      ood_err: |served energy - the match's energy|;
    and, per image, ``empty_rows``: rows left empty while the reference
    still had a candidate, and ``picks``: rows in which it had one."""
    b, max_out = dets.shape[:2]
    rows = torch.arange(b, device=dets.device)
    scores = c.scores.clone()
    side = (c.boxes[..., 2:] - c.boxes[..., :2]).amax(-1).clamp(min=1.0)
    picks = torch.zeros(b, dtype=torch.long, device=dets.device)
    empty = torch.zeros(b, dtype=torch.long, device=dets.device)
    per_row = {k: [] for k in ("image", "box_err", "pick_gap", "score_err",
                               "class_err", "ood_err")}
    for t in range(max_out):
        row = dets[:, t]
        served = row[:, 4] > 0
        cls = (row[:, 5].long() - 1).clamp(min=0)
        best = scores.max(1).values
        left = best > 0
        picks += left
        empty += ~served & left
        dist = (c.boxes - row[:, None, :4]).abs().amax(-1) / side
        rel = torch.where(scores > 0, dist, torch.full_like(dist, 1e9))
        near = rel <= rel.min(1, keepdim=True).values + 1e-6
        tie = (c.classes != cls[:, None]).float() * 2 + \
            (scores - row[:, 4:5]).abs()
        j = torch.where(near, tie, torch.full_like(dist, np.inf)).argmin(1)
        err = rel[rows, j]
        found = served & (err < 1e9)
        ref = scores[rows, j]
        one = torch.ones_like(err)
        gap = {
            "image": rows.float(),
            "box_err": err,
            "pick_gap": torch.where(found, (best - ref) / best.clamp(
                min=1e-30), one),
            "score_err": torch.where(found, (row[:, 4] - ref).abs() /
                                     ref.clamp(min=1e-30), one),
            "class_err": torch.where(found, (c.classes[rows, j] != cls)
                                     .float(), one),
            "ood_err": torch.where(found, (ood[:, t] - c.energy[rows, j])
                                   .abs(), torch.full_like(err, np.inf))}
        for k, v in gap.items():
            per_row[k].append(v[served])
        scores = torch.where(found[:, None], _decay(c, scores, j, cls),
                             scores)
    out = {k: torch.cat(v).cpu() for k, v in per_row.items()}
    out["image"] = out["image"].long()
    out.update(empty_rows=empty.cpu(), picks=picks.cpu())
    return out
