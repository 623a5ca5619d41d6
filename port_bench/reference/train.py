"""The plain train step: anchor labeling, focal + huber loss, backward,
global-norm clipped SGD with momentum, and the EMA of the parameters.

The published EfficientDet recipe as effdet trains it: an anchor takes the
ground-truth row of highest IoU at 0.5 or above, and each row also claims
its own best anchor (the lowest row wins a contested anchor); class
targets are one-hot, the class loss the alpha-weighted sigmoid cross
entropy (effdet's active focal path, without the (1 - p)^gamma factor),
the box loss the huber loss of the (ty, tx, th, tw) codes on matched
anchors, both over the positives + 1; the update clips the gradient to a
global norm of 10, steps SGD (momentum 0.9) at the learning rate of the
schedule's linear warm-up, and moves the EMA by min(decay, (1 + n) /
(10 + n)).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .model import TAPS

EPS = 1e-8


def box_iou_yxyx(gt: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """[M, 4] x [A, 4] yxyx -> [M, A] IoU, 0 where the boxes do not meet."""
    ih = (torch.minimum(gt[:, None, 2], anchors[:, 2])
          - torch.maximum(gt[:, None, 0], anchors[:, 0])).clamp(min=0)
    iw = (torch.minimum(gt[:, None, 3], anchors[:, 3])
          - torch.maximum(gt[:, None, 1], anchors[:, 1])).clamp(min=0)
    inter = ih * iw
    area = lambda b: (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area(gt)[:, None] + area(anchors) - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


def encode(boxes: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """yxyx boxes against yxyx anchors -> (ty, tx, th, tw)."""
    ha = anchors[..., 2] - anchors[..., 0] + EPS
    wa = anchors[..., 3] - anchors[..., 1] + EPS
    h = boxes[..., 2] - boxes[..., 0] + EPS
    w = boxes[..., 3] - boxes[..., 1] + EPS
    ty = ((boxes[..., 0] + boxes[..., 2]) - (anchors[..., 0] + anchors[..., 2])) / 2 / ha
    tx = ((boxes[..., 1] + boxes[..., 3]) - (anchors[..., 1] + anchors[..., 3])) / 2 / wa
    return torch.stack([ty, tx, torch.log(h / ha), torch.log(w / wa)], -1)


def label(anchors: torch.Tensor, gt_boxes: torch.Tensor,
          gt_classes: torch.Tensor, threshold: float = 0.5):
    """Ground truth [B, M, 4] yxyx / [B, M] (1-based, -1 padding) ->
    (class targets [B, A]: class - 1, or -1 for background; box targets
    [B, A, 4]; matched row [B, A] or -1; positives [B])."""
    cls_t, box_t, match_t = [], [], []
    rows_all = torch.arange(gt_boxes.shape[1], device=anchors.device)
    for boxes, classes in zip(gt_boxes, gt_classes):
        valid = classes > -1
        sim = torch.where(valid[:, None], box_iou_yxyx(boxes, anchors),
                          torch.full((len(boxes), len(anchors)), -1.0,
                                     device=anchors.device))
        best, row = sim.max(0)           # first of equal maxima
        row = torch.where(best >= threshold, row, torch.full_like(row, -1))
        # each valid row claims its own best anchor; the lowest row wins
        m, a = sim.shape
        claim = torch.where(valid, sim.argmax(1), a)
        force = torch.full((a + 1,), m, device=anchors.device)
        force.scatter_reduce_(0, claim, rows_all, reduce="amin")
        row = torch.where(force[:a] < m, force[:a], row)
        matched = row >= 0
        safe = row.clamp(min=0)
        cls_t.append(torch.where(matched, classes[safe].long() - 1,
                                 torch.full_like(row, -1)))
        codes = encode(boxes[safe], anchors)
        box_t.append(torch.where(matched[:, None], codes,
                                 torch.zeros_like(codes)))
        match_t.append(row)
    match = torch.stack(match_t)
    return (torch.stack(cls_t), torch.stack(box_t), match,
            (match >= 0).float().sum(1))


def detection_loss(cls_levels: List[torch.Tensor],
                   box_levels: List[torch.Tensor], cls_t: torch.Tensor,
                   box_t: torch.Tensor, positives: torch.Tensor, cfg: Dict
                   ) -> torch.Tensor:
    """Class loss + box_loss_weight x box loss of one batch."""
    b, c = cls_t.shape[0], cfg["num_classes"]
    logits = torch.cat([x.reshape(b, -1, c) for x in cls_levels], 1)
    codes = torch.cat([x.reshape(b, -1, 4) for x in box_levels], 1)
    norm = positives.sum() + 1.0
    onehot = torch.nn.functional.one_hot(cls_t.clamp(min=0), c).float() \
        * (cls_t >= 0)[..., None]
    alpha = cfg["alpha"]
    weight = onehot * alpha + (1 - onehot) * (1 - alpha)
    bce = torch.nn.functional.binary_cross_entropy_with_logits(
        logits, onehot, reduction="none")
    cls_loss = (weight * bce).sum() / norm
    err = (codes - box_t).abs()
    delta = cfg["delta"]
    quad = err.clamp(max=delta)
    huber = (0.5 * quad * quad + delta * (err - quad)) * (box_t != 0)
    return cls_loss + cfg["box_loss_weight"] * huber.sum() / (norm * 4.0)


def forward_checkpointed(model, images: torch.Tensor):
    """The reference forward with every backbone block recomputed in the
    backward pass, so that a full batch fits in float32."""
    bb = model.backbone
    x = images.permute(0, 3, 1, 2).float()
    x = torch.nn.functional.silu(bb.bn1(bb.conv_stem(x)))
    feats = []
    for i, stage in enumerate(bb.blocks):
        if i in TAPS:
            feats.append(x)
        for block in stage:
            x = checkpoint(block, x, use_reentrant=False)
    feats = model.fpn(feats + [x])
    return model.class_net(feats), model.box_net(feats)


def warmup_lr(tcfg: Dict, step: int) -> float:
    """The learning rate of ``step`` (from 0) inside the linear warm-up
    from ``warmup_lr`` to ``lr`` over ``warmup_epochs`` epochs."""
    steps = tcfg["warmup_epochs"] * tcfg["steps_per_epoch"]
    if step >= steps:
        raise ValueError("the reference follows the first steps only")
    return tcfg["warmup_lr"] + (tcfg["lr"] - tcfg["warmup_lr"]) * step / steps


class Sgd:
    """SGD with momentum (the buffer starts at the first gradient), a
    global-norm clip, and the EMA of the parameters."""

    def __init__(self, params: Dict[str, torch.Tensor], lr,
                 momentum: float, clip: float, ema_decay: float):
        self.params = params
        self.lr, self.momentum, self.clip = lr, momentum, clip
        self.ema_decay = ema_decay
        self.buf: Dict[str, torch.Tensor] = {}
        self.ema = {k: p.detach().clone() for k, p in params.items()}
        self.steps = 0

    @torch.no_grad()
    def step(self) -> Dict[str, torch.Tensor]:
        """Apply the update; returns the clipped gradients."""
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
        if norm >= self.clip:
            grads = {k: g * (self.clip / norm).float() for k, g in grads.items()}
        for k, p in self.params.items():
            buf = self.buf.get(k)
            buf = grads[k].clone() if buf is None else \
                buf.mul_(self.momentum).add_(grads[k])
            self.buf[k] = buf
            p.sub_(self.lr(self.steps) * buf)
            p.grad = None
        self.steps += 1
        d = min(self.ema_decay, (1.0 + self.steps) / (10.0 + self.steps))
        for k, p in self.params.items():
            self.ema[k].mul_(d).add_(p * (1 - d))
        return grads


def train_steps(model, cfg: Dict, batches: List[Dict[str, torch.Tensor]],
                anchors: torch.Tensor, tcfg: Dict
                ) -> Tuple[List[float], Dict[str, torch.Tensor],
                           Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the reference step over ``batches`` from the model's present
    state. Returns (each step's loss, the first step's clipped gradients,
    the parameters after the last step, the EMA after the last step)."""
    params = dict(model.named_parameters())
    opt = Sgd(params, lambda step: warmup_lr(tcfg, step), tcfg["momentum"],
              tcfg["clip_grad_norm"], tcfg["ema_decay"])
    losses, first = [], None
    for batch in batches:
        model.train_bn()
        cls_t, box_t, _, pos = label(anchors, batch["bbox"], batch["cls"])
        cls_out, box_out = forward_checkpointed(model, batch["image"])
        loss = detection_loss(cls_out, box_out, cls_t, box_t, pos, cfg)
        loss.backward()
        losses.append(float(loss.detach()))
        grads = opt.step()
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
    model.eval()
    return losses, first, {k: p.detach().clone() for k, p in params.items()}, \
        opt.ema
