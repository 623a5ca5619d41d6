"""Batched fixed-shape detection post-processing.

Port of ``ood_object_detection_tpu.ops.post_process``: per-level head
outputs -> top-k candidates -> decode against anchors rebuilt by index
arithmetic -> clip -> strict score filter -> class-offset (soft-)NMS ->
``[B, max_det, 6]`` detections ``[x1, y1, x2, y2, score, class + 1]`` and
``[B, max_det]`` OOD scores. Padding rows are 0.

Three selections (``topk_method``), as in the JAX package:
  - ``per_anchor``: each anchor's best class (max, argmax), then the top
    anchors;
  - ``exact``: the top (anchor, class) pairs in two stages: the top
    anchors by their max logit, then the top pairs among those anchors'
    class rows (``_exact_topk_pairs``);
  - ``approx``: the top pairs of the flat [B, A*C] logits (the JAX
    package's ``approx_max_k``, exact on the CPU; exact here).

Two hand-written kernels carry it on the card: K2 (``ops/cuda_reduce.py``)
for the per-anchor key + energy pass over bf16 logits, K1
(``ops/cuda_nms.py``) for the NMS. ``select_candidates`` and
``batch_detection`` take ``kernels=False`` to run the plain versions
instead, on any device, so that a run on the card can hold the two
against each other.

Selection is bit-exact with the JAX package: its top-k (``lax.top_k``,
and ``approx_max_k``, exact on the CPU) returns equal values lowest index
first, which ``torch.topk`` does not promise; ``_topk`` sorts stably
instead, in every selection.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import cuda_nms, cuda_reduce
from .anchors import Anchors
from .box_coder import decode_boxes
from .boxes import clip_boxes_xyxy
from .nms import batched_nms_plain
from .ood import _SCORERS, ood_score
from ..utils.profiling import span

MIN_SCORE = 0.01   # reference score pre-filter, strict (scores > MIN_SCORE)
# NMS coordinate guard: far above any image coordinate, far below f32 inf,
# so a diverged head's inf box cannot make the class offset 0 * inf = NaN
MAX_COORD = 1e7


TOPK_METHODS = ("per_anchor", "exact", "approx")


def _check_ood_method(ood_method: Optional[str]) -> None:
    """Unknown OOD methods fail on every dtype path (the bf16 path would
    otherwise fall through to msp)."""
    if ood_method is not None and ood_method not in _SCORERS:
        raise ValueError(f"unknown ood_method {ood_method!r}; expected one "
                         f"of {sorted(_SCORERS)}")


def _topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along dim 1, descending, equal values lowest index first (the
    order of jax's top-k). A stable descending sort gives that order."""
    vals, idx = torch.sort(values, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _per_anchor_reduce(cls_outputs: List[torch.Tensor], num_classes: int,
                       ood_method: Optional[str] = None):
    """(max logit [B, A_tot], argmax class [B, A_tot] int32, OOD score
    [B, A_tot] f32 or None) over per-level [B, H, W, A*C] logits."""
    maxes, args, oods = [], [], []
    for lvl in cls_outputs:
        b = lvl.shape[0]
        r = lvl.reshape(*lvl.shape[:3], -1, num_classes)
        maxes.append(torch.amax(r, dim=-1).reshape(b, -1))
        args.append(torch.argmax(r, dim=-1).to(torch.int32).reshape(b, -1))
        if ood_method is not None:
            oods.append(ood_score(r.to(torch.float32), ood_method)
                        .reshape(b, -1))
    ood_all = torch.cat(oods, dim=1) if ood_method is not None else None
    return torch.cat(maxes, dim=1), torch.cat(args, dim=1), ood_all


def _packed_f32_key_reduce(cls_outputs: List[torch.Tensor], num_classes: int,
                           ood_method: Optional[str] = None,
                           kernels: bool = True):
    """(key_all [B, A_tot] f32, energy [B, A_tot] f32 or None): K2, or its
    plain version with ``kernels=False``. Only energy needs the extra
    reduce; max_logit and msp are read back from the key."""
    reduce = (cuda_reduce.key_energy_reduce if kernels
              else cuda_reduce.key_energy_reduce_plain)
    return reduce(cls_outputs, num_classes, ood_method == "energy")


def _unpack_f32_key(vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of the packed key: f32 keys -> (logit f32, class int32)."""
    mono16 = torch.floor(vals * (1.0 / 256.0))
    rem = vals - mono16 * 256.0
    classes = (255.0 - rem).to(torch.int32)
    mono = mono16.to(torch.int32)
    bits = torch.where(mono < 0x8000, 0xFFFF - mono, mono & 0x7FFF)
    bits16 = torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)
    return bits16.view(torch.bfloat16).to(torch.float32), classes


def _packed(cls_outputs: List[torch.Tensor], num_classes: int) -> bool:
    """bf16 logits of at most 256 classes take the packed-key path (K2)."""
    return cls_outputs[0].dtype == torch.bfloat16 and num_classes <= 256


def _anchor_max_and_ood(cls_outputs: List[torch.Tensor], num_classes: int,
                        ood_method: Optional[str], kernels: bool = True):
    """(each anchor's max logit [B, A_tot], its OOD score [B, A_tot] f32 or
    None). On the packed-key path both come from K2 (``kernels=False``: its
    plain version): the key carries the anchor's bf16 max exactly, so
    max_logit is the unpacked key and msp = max_c sigmoid(l_c) =
    sigmoid(max_c l_c); energy is the kernel's. Other logits take the
    two-reduce path."""
    if not _packed(cls_outputs, num_classes):
        max_all, _, ood_all = _per_anchor_reduce(cls_outputs, num_classes,
                                                 ood_method)
        return max_all, ood_all
    key_all, ood_all = _packed_f32_key_reduce(cls_outputs, num_classes,
                                              ood_method, kernels=kernels)
    max_all, _ = _unpack_f32_key(key_all)
    if ood_method == "max_logit":
        ood_all = max_all
    elif ood_method == "msp":
        ood_all = torch.sigmoid(max_all)
    return max_all, ood_all


def _gather_class_rows(cls_outputs: List[torch.Tensor], num_classes: int,
                       anchor_ids: torch.Tensor) -> torch.Tensor:
    """[B, K, C] f32 class-logit rows of K global anchor ids, gathered level
    by level from anchor-major [B, N_l, C] views."""
    b, k = anchor_ids.shape
    out = torch.zeros((b, k, num_classes), dtype=torch.float32,
                      device=anchor_ids.device)
    offset = 0
    for lvl in cls_outputs:
        n = lvl.shape[1] * lvl.shape[2] * (lvl.shape[3] // num_classes)
        view = lvl.reshape(b, n, num_classes)
        local = torch.clamp(anchor_ids - offset, 0, n - 1)
        rows = torch.gather(view, 1,
                            local[..., None].expand(-1, -1, num_classes))
        in_level = (anchor_ids >= offset) & (anchor_ids < offset + n)
        out = torch.where(in_level[..., None], rows.to(torch.float32), out)
        offset += n
    return out


def _exact_topk_pairs(cls_outputs: List[torch.Tensor], num_classes: int,
                      k: int, ood_method: Optional[str] = None,
                      kernels: bool = True):
    """The top k (anchor, class) pairs over all levels, in two stages, as
    the JAX package's ``_exact_topk_pairs``: the top min(k, A) anchors by
    their max logit, then the top k of those anchors' k1 * C pairs (any
    pair of the global top k lies on such an anchor). Both sorts are
    stable, so ties go lowest anchor, then lowest pair index first.

    Stage 1 on bf16 logits reads K2's packed keys
    (``_anchor_max_and_ood``); sorting the unpacked maxima, not the keys,
    keeps the key's class bits out of the tie order.

    Returns (vals [B, k] f32 descending, anchor ids [B, k], classes [B, k]
    int32, per-anchor OOD [B, A_tot] or None).
    """
    batch = cls_outputs[0].shape[0]
    max_all, ood_all = _anchor_max_and_ood(cls_outputs, num_classes,
                                           ood_method, kernels)
    a_tot = max_all.shape[1]
    k = min(k, a_tot * num_classes)
    k1 = min(k, a_tot)
    _, top_anchors = _topk(max_all, k1)
    rows = _gather_class_rows(cls_outputs, num_classes, top_anchors)
    vals, pos = _topk(rows.reshape(batch, k1 * num_classes), k)
    classes = (pos % num_classes).to(torch.int32)
    anchor_ids = torch.gather(top_anchors, 1, pos // num_classes)
    return vals, anchor_ids, classes, ood_all


def _approx_topk_pairs(cls_outputs: List[torch.Tensor], num_classes: int,
                       k: int, ood_method: Optional[str] = None,
                       kernels: bool = True):
    """The top k (anchor, class) pairs of the flat [B, A*C] logits by one
    stable sort, lowest flat index first on ties: the JAX package's
    ``approx_max_k`` path, which is exact on the CPU for k below the row
    length. The OOD scores come from ``_anchor_max_and_ood`` (K2 on bf16
    logits).

    Returns (logits [B, k] in the input dtype, anchor ids [B, k], classes
    [B, k] int32, per-anchor OOD [B, A_tot] or None)."""
    batch = cls_outputs[0].shape[0]
    flat = torch.cat([lvl.reshape(batch, -1) for lvl in cls_outputs], dim=1)
    vals, top = _topk(flat, min(k, flat.shape[1]))
    ood_all = None if ood_method is None else _anchor_max_and_ood(
        cls_outputs, num_classes, ood_method, kernels)[1]
    return (vals, top // num_classes, (top % num_classes).to(torch.int32),
            ood_all)


def _gather_survivor_scores(ood_all: torch.Tensor, keep_idx: torch.Tensor,
                            indices: torch.Tensor) -> torch.Tensor:
    """Per-anchor scores [B, A_tot] of the NMS survivors (keep_idx ->
    candidate slot -> anchor id); padding rows get 0."""
    valid = keep_idx >= 0
    anchor_ids = torch.gather(indices, 1, keep_idx.clamp(min=0).long())
    gathered = torch.gather(ood_all, 1, anchor_ids)
    return torch.where(valid, gathered, torch.zeros_like(gathered))


def _gather_boxes(box_outputs: List[torch.Tensor],
                  indices: torch.Tensor) -> torch.Tensor:
    """[B, k, 4] box regressions of the selected anchors."""
    b = indices.shape[0]
    box_all = torch.cat([lvl.reshape(b, -1, 4) for lvl in box_outputs], dim=1)
    return torch.gather(box_all, 1, indices[..., None].expand(-1, -1, 4))


class Candidates(NamedTuple):
    """The top-k anchors of each image, ready for NMS."""
    logits: torch.Tensor          # [B, k, 1] winning-class logit
    box_codes: torch.Tensor       # [B, k, 4] box regressions
    anchors: Optional[torch.Tensor]   # [B, k, 4] yxyx anchors
    classes: torch.Tensor         # [B, k] int32 winning class
    indices: torch.Tensor         # [B, k] anchor ids
    key_all: Optional[torch.Tensor]   # [B, A_tot] packed keys (bf16 path)
    ood_all: Optional[torch.Tensor]   # [B, A_tot] OOD score per anchor


def select_candidates(cls_outputs: List[torch.Tensor],
                      box_outputs: List[torch.Tensor],
                      anchors: Optional[Anchors],
                      num_classes: int, max_detection_points: int,
                      ood_method: Optional[str] = None,
                      kernels: bool = True,
                      topk_method: str = "per_anchor") -> Candidates:
    """Top-k selection (``topk_method``) -> the candidates' boxes and
    anchors, with the per-anchor OOD scores when ``ood_method`` is set.

    ``per_anchor`` on bf16 logits (and num_classes <= 256) takes the
    packed-key path: one pass (K2) gives each anchor one exact f32 key
    carrying its max logit and class, plus the energy when it is asked
    for; other logits take the two-reduce path (max, argmax, OOD score).
    ``exact`` and ``approx`` select (anchor, class) pairs
    (``_exact_topk_pairs``, ``_approx_topk_pairs``) and return the OOD
    scores of every method in ``ood_all``. With ``anchors`` None the
    candidates carry no anchors (``post_process``).
    """
    if topk_method not in TOPK_METHODS:
        raise ValueError(f"unknown topk_method {topk_method!r}; expected one "
                         f"of {TOPK_METHODS}")
    with span("odt.select"):
        key_all = None
        if topk_method != "per_anchor":
            select = (_exact_topk_pairs if topk_method == "exact"
                      else _approx_topk_pairs)
            logits, indices, classes, ood_all = select(
                cls_outputs, num_classes, max_detection_points, ood_method,
                kernels=kernels)
        elif _packed(cls_outputs, num_classes):
            key_all, ood_all = _packed_f32_key_reduce(
                cls_outputs, num_classes, ood_method, kernels=kernels)
            k = min(max_detection_points, key_all.shape[1])
            vals, indices = _topk(key_all, k)
            logits, classes = _unpack_f32_key(vals)
        else:
            max_all, arg_all, ood_all = _per_anchor_reduce(
                cls_outputs, num_classes, ood_method)
            k = min(max_detection_points, max_all.shape[1])
            logits, indices = _topk(max_all, k)
            classes = torch.gather(arg_all, 1, indices)
        return Candidates(
            logits[..., None], _gather_boxes(box_outputs, indices),
            None if anchors is None else anchors.boxes_for_indices(indices),
            classes, indices, key_all, ood_all)


def post_process(cls_outputs: List[torch.Tensor],
                 box_outputs: List[torch.Tensor], num_classes: int,
                 max_detection_points: int = 5000,
                 topk_method: str = "per_anchor", topk_recall: float = 0.95
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """The global top-k candidates over all levels: (cls_topk [B, k, 1]
    winning-class logits, box_topk [B, k, 4] regressions, anchor indices
    [B, k], classes [B, k] int32), the reference ``_post_process``
    contract (effdet/bench.py:12-56) and the JAX package's
    ``post_process``. The selection is ``select_candidates``'s;
    ``topk_recall`` is accepted for the JAX signature and unused, since
    every selection here is exact. On the packed-key path (bf16 logits,
    ``per_anchor``) the logits come back in f32, each the exact value of
    its bf16 logit."""
    cand = select_candidates(cls_outputs, box_outputs, None, num_classes,
                             max_detection_points, topk_method=topk_method)
    return cand.logits, cand.box_codes, cand.indices, cand.classes


def nms_inputs(cls_logits: torch.Tensor, box_out: torch.Tensor,
               anchors_sel: torch.Tensor, classes: torch.Tensor,
               img_scale: Optional[torch.Tensor] = None,
               img_size: Optional[torch.Tensor] = None):
    """(xyxy boxes [B, k, 4], scores [B, k], class-offset NMS boxes
    [B, k, 4]) of the candidates: decode, clip to the original image when
    img_scale [B] or [B, 1] and img_size [B, 2] (w, h) are given, sigmoid,
    the strict MIN_SCORE filter, and the per-image class offset."""
    boxes = decode_boxes(box_out.to(torch.float32), anchors_sel,
                         output_xyxy=True)
    if img_scale is not None and img_size is not None:
        img_scale = img_scale.reshape(img_scale.shape[0], -1)[:, :1]
        size_hw = (img_size / img_scale)[:, None].flip(-1)       # [B, 1, 2]
        boxes = clip_boxes_xyxy(boxes, size_hw)

    scores = torch.sigmoid(cls_logits[..., 0].to(torch.float32))
    scores = torch.where(scores > MIN_SCORE, scores, torch.zeros_like(scores))

    # coordinates are clamped to MAX_COORD before the offset
    nms_boxes = torch.clamp(boxes, -MAX_COORD, MAX_COORD)
    max_coord = torch.amax(nms_boxes, dim=(1, 2), keepdim=True)
    offsets = classes.to(boxes.dtype)[..., None] * (max_coord + 1.0)
    return boxes, scores, nms_boxes + offsets


def batch_detection(cls_logits: torch.Tensor, box_out: torch.Tensor,
                    anchors_sel: torch.Tensor, classes: torch.Tensor,
                    img_scale: Optional[torch.Tensor] = None,
                    img_size: Optional[torch.Tensor] = None,
                    max_det_per_image: int = 100, soft_nms: bool = False,
                    iou_threshold: float = 0.3, kernels: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates -> ([B, max_det, 6] detections, [B, max_det] keep_idx).

    cls_logits [B, k, 1], box_out [B, k, 4] regressions, anchors_sel
    [B, k, 4] yxyx anchors of the candidates, classes [B, k]. With
    img_scale and img_size, boxes are clipped to the original image and
    scaled back to it. NMS is K1 (gaussian soft-NMS with ``soft_nms``), or
    its plain version with ``kernels=False``.
    """
    with span("odt.nms"):
        boxes, scores, offset_boxes = nms_inputs(
            cls_logits, box_out, anchors_sel, classes, img_scale, img_size)
        nms = cuda_nms.batched_nms if kernels else batched_nms_plain
        keep_idx, keep_scores = nms(
            offset_boxes, scores, max_out=max_det_per_image,
            iou_threshold=iou_threshold, soft=soft_nms, sigma=0.5,
            score_threshold=0.001)

        valid = keep_idx >= 0
        safe = keep_idx.clamp(min=0).long()
        zeros = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
        out_boxes = torch.where(
            valid[..., None],
            torch.gather(boxes, 1, safe[..., None].expand(-1, -1, 4)), zeros)
        out_scores = torch.where(valid, keep_scores, zeros)
        out_classes = torch.where(
            valid, torch.gather(classes, 1, safe).to(torch.float32) + 1.0,
            zeros)
        if img_scale is not None and img_size is not None:
            out_boxes = out_boxes * img_scale.reshape(
                img_scale.shape[0], -1)[:, :1, None]
        detections = torch.cat(
            [out_boxes, out_scores[..., None], out_classes[..., None]],
            dim=-1)
        return detections, keep_idx


def generate_detections(cls_outputs: List[torch.Tensor],
                        box_outputs: List[torch.Tensor],
                        anchors: Anchors, num_classes: int,
                        img_scale: Optional[torch.Tensor] = None,
                        img_size: Optional[torch.Tensor] = None,
                        max_detection_points: int = 5000,
                        max_det_per_image: int = 100,
                        soft_nms: bool = False, iou_threshold: float = 0.3,
                        ood_method: Optional[str] = None,
                        topk_method: str = "per_anchor"
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Head outputs -> ([B, max_det, 6] detections, [B, max_det] OOD or
    None).

    cls_outputs / box_outputs: per-level [B, H, W, A*C] / [B, H, W, A*4]
    (NHWC). ``topk_method`` selects the candidates (``select_candidates``);
    on the per_anchor packed-key path max_logit and msp come back from the
    survivors' keys.
    """
    _check_ood_method(ood_method)
    cand = select_candidates(cls_outputs, box_outputs, anchors, num_classes,
                             max_detection_points, ood_method,
                             topk_method=topk_method)
    detections, keep_idx = batch_detection(
        cand.logits, cand.box_codes, cand.anchors, cand.classes,
        img_scale=img_scale, img_size=img_size,
        max_det_per_image=max_det_per_image, soft_nms=soft_nms,
        iou_threshold=iou_threshold)

    if ood_method is None:
        return detections, None
    if cand.ood_all is not None:
        return detections, _gather_survivor_scores(cand.ood_all, keep_idx,
                                                   cand.indices)
    # max_logit / msp on the packed path: the key carries each anchor's
    # max (bf16) logit; msp = max_c sigmoid(l_c) = sigmoid(max_c l_c)
    logit, _ = _unpack_f32_key(
        _gather_survivor_scores(cand.key_all, keep_idx, cand.indices))
    score = logit if ood_method == "max_logit" else torch.sigmoid(logit)
    return detections, torch.where(keep_idx >= 0, score,
                                   torch.zeros_like(score))
