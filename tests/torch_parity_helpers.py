"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port, which runs on the CPU with its kernels' plain versions.
"""
import jax
import numpy as np
import torch

# the tier-1 run uses several xdist workers: keep each one's torch small
torch.set_num_threads(2)


def random_variables(init_fn, seed):
    """The variable tree that ``init_fn(key)`` (a flax ``init``) would
    make, filled from numpy instead: kernels at fan-in scale, BatchNorm
    statistics and affines away from the identity, positive BiFPN edge
    weights, small biases and means."""
    shapes = jax.eval_shape(init_fn, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, s.shape)
        elif leaf == "edge_weights":
            v = np.abs(rng.normal(1, 0.2, s.shape))
        else:                                          # bias, mean
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, shapes[c])
            for c in shapes}


def head_outputs(feat_sizes, min_level, max_level, num_classes, rng,
                 batch=2, num_anchors=9, cls_mean=-6.0, ties=False):
    """Per-level NHWC class / box outputs [B, H, W, A*C] / [B, H, W, A*4]
    as f32 numpy. ``ties``: logits on a coarse grid, so bf16 values (and
    packed keys) repeat often."""
    cls_out, box_out = [], []
    for lvl in range(min_level, max_level + 1):
        h, w = feat_sizes[lvl]
        c = rng.normal(cls_mean, 1.5, (batch, h, w, num_anchors * num_classes))
        if ties:    # (+ 0.0 turns -0.0 into 0.0: the key orders -0 < +0)
            c = np.round(c * 4) / 4 + 0.0
        cls_out.append(c.astype(np.float32))
        box_out.append(rng.normal(0, 0.3, (batch, h, w, num_anchors * 4))
                       .astype(np.float32))
    return cls_out, box_out


def to_torch(arrays, dtype=torch.float32):
    """numpy f32 arrays -> torch tensors, rounded to ``dtype`` as jax's
    ``astype`` rounds (both round to nearest even)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def to_numpy(t):
    return t.detach().to(torch.float32).cpu().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()
