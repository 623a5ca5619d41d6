"""The port's losses against the JAX package's (``ops/losses.py``) on the
same numpy inputs, mirroring tests/test_losses.py.

Tolerances: f32 elementwise losses to rtol 1e-6 / atol 1e-7 (the same
operations; exp / log1p may round in the last bit differently); summed
losses to rtol 2e-5 (sums in another order, as test_losses.py holds the
flat and per-level JAX losses to each other); gradients to rtol 1e-5 /
atol 1e-7 (test_losses.py's fused-vs-oracle tolerance). bf16: XLA's CPU
code keeps a fused chain of bf16 operations in f32 and rounds once, torch
rounds after every operation, so elementwise bf16 losses are held to four
bf16 steps (rtol = atol = 2^-6) and summed bf16 losses to rtol 1e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.ops import losses as jl
from ood_object_detection_tpu_torch.ops import losses as tl

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _np(t):
    return t.detach().float().numpy()


def _elem_tol(dtype):
    return dict(rtol=1e-6, atol=1e-7) if dtype == "float32" else \
        dict(rtol=2 ** -6, atol=2 ** -6)


def _nhwc_inputs(rng, b=2, c=7, a=3, shapes=((8, 8), (4, 4), (2, 2))):
    cls_out = [rng.normal(0, 2, (b, h, w, a * c)).astype(np.float32)
               for h, w in shapes]
    box_out = [rng.normal(0, 1, (b, h, w, a * 4)).astype(np.float32)
               for h, w in shapes]
    a_tot = sum(h * w * a for h, w in shapes)
    cls_t = rng.integers(-2, c, (b, a_tot)).astype(np.int32)
    box_t = np.where(rng.uniform(size=(b, a_tot, 4)) > 0.7,
                     rng.normal(0, 1, (b, a_tot, 4)), 0.0).astype(np.float32)
    num_pos = rng.uniform(1, 5, b).astype(np.float32)
    return cls_out, box_out, cls_t, box_t, num_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_elementwise_losses_match_jax(dtype):
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (64, 9)).astype(np.float32)
    targets = (rng.uniform(size=(64, 9)) > 0.7).astype(np.float32)
    x, jx = _pair(logits, dtype)
    t, jt = _pair(targets, dtype)
    tol = _elem_tol(dtype)
    pairs = [
        (tl.sigmoid_bce(x, t), jl.sigmoid_bce(jx, jt)),
        (tl.focal_loss_legacy(x, t, 0.25, 1.5, 10.0),
         jl.focal_loss_legacy(jx, jt, 0.25, 1.5, 10.0)),
        (tl.new_focal_loss(x, t, 0.25, 1.5, 3.0, label_smoothing=0.01),
         jl.new_focal_loss(jx, jt, 0.25, 1.5, 3.0, label_smoothing=0.01)),
        (tl.new_focal_loss(x, t, 0.25, 2.0, 3.0, modulation=True),
         jl.new_focal_loss(jx, jt, 0.25, 2.0, 3.0, modulation=True)),
        (tl.new_focal_loss(x, t, None, 2.0, 1.0, label_smoothing=0.0),
         jl.new_focal_loss(jx, jt, None, 2.0, 1.0, label_smoothing=0.0)),
    ]
    for ours, ref in pairs:
        assert ours.dtype == DTYPES[dtype][0]
        np.testing.assert_allclose(_np(ours), np.asarray(ref, np.float32),
                                   **tol)
    # an f32 array normaliser promotes the loss to f32, as in jax
    npos = torch.tensor(3.0)
    ours = tl.new_focal_loss(x, t, 0.25, 1.5, npos)
    ref = jl.new_focal_loss(jx, jt, 0.25, 1.5, jnp.float32(3.0))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    np.testing.assert_allclose(_np(ours), np.asarray(ref), **tol)


def test_huber_and_one_hot_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (50, 4)).astype(np.float32)
    y = rng.normal(0, 1, (50, 4)).astype(np.float32)
    w = (rng.uniform(size=(50, 4)) > 0.5).astype(np.float32)
    for kw in (dict(delta=0.1, size_average=False),
               dict(delta=1.0, size_average=True)):
        ours = tl.huber_loss(torch.from_numpy(x), torch.from_numpy(y),
                             weights=torch.from_numpy(w), **kw)
        ref = jl.huber_loss(x, y, weights=w, **kw)
        np.testing.assert_allclose(float(ours), float(ref), rtol=2e-6)
    assert float(tl.huber_loss(torch.tensor([0.0, 0.5, 2.0]),
                               torch.zeros(3), size_average=False)) == 1.625
    labels = np.array([2, -1, 0, -2, 3], np.int32)
    np.testing.assert_array_equal(
        tl.one_hot(torch.from_numpy(labels), 4).numpy(),
        np.asarray(jl.one_hot(labels, 4)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("legacy", [False, True])
def test_detection_loss_flat_and_nhwc_match_jax(dtype, legacy):
    """The flat loss and the per-level NHWC loss (the fused alpha-only
    path, or the legacy focal path) against JAX's, and against each
    other."""
    rng = np.random.default_rng(2)
    cls_out, box_out, cls_t, box_t, num_pos = _nhwc_inputs(rng)
    c = 7
    kw = dict(num_classes=c, alpha=0.25, gamma=1.5, delta=0.1,
              box_loss_weight=50.0, label_smoothing=0.01,
              legacy_focal=legacy)
    tc = [_pair(a, dtype)[0] for a in cls_out]
    tb = [_pair(a, dtype)[0] for a in box_out]
    jc = [_pair(a, dtype)[1] for a in cls_out]
    jb = [_pair(a, dtype)[1] for a in box_out]
    targets = (torch.from_numpy(cls_t), torch.from_numpy(box_t),
               torch.from_numpy(num_pos))
    flat = tl.detection_loss_flat(tl.levels_to_flat(tc, c),
                                  tl.levels_to_flat(tb, 4), *targets, **kw)
    nhwc = tl.detection_loss_nhwc(tc, tb, *targets, **kw)
    ref = jl.detection_loss_nhwc(jc, jb, cls_t, box_t, num_pos, **kw)
    ref_flat = jl.detection_loss_flat(jl.levels_to_flat(jc, c),
                                      jl.levels_to_flat(jb, 4), cls_t, box_t,
                                      num_pos, **kw)
    rtol = 2e-5 if dtype == "float32" else 1e-2
    for ours, r, rf, f in zip(nhwc, ref, ref_flat, flat):
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(r), rtol=rtol)
        np.testing.assert_allclose(float(f), float(rf), rtol=rtol)
        np.testing.assert_allclose(float(ours), float(f), rtol=rtol)


@pytest.mark.parametrize("alpha, smooth", [(0.25, 0.01), (None, 0.0)])
def test_fused_focal_grads_match_jax_flat_oracle(alpha, smooth):
    """FusedAlphaFocalSum (through detection_loss_nhwc) against jax.grad of
    the plain one-hot formulation, ``detection_loss_flat``: value and
    logit gradients (test_fused_focal_grads_match_flat_oracle)."""
    rng = np.random.default_rng(3)
    cls_out, box_out, cls_t, box_t, num_pos = _nhwc_inputs(rng)
    c = 7
    kw = dict(num_classes=c, alpha=alpha, gamma=1.5, delta=0.1,
              box_loss_weight=50.0, label_smoothing=smooth)
    tc = [torch.from_numpy(a).requires_grad_() for a in cls_out]
    total = tl.detection_loss_nhwc(
        tc, [torch.from_numpy(a) for a in box_out], torch.from_numpy(cls_t),
        torch.from_numpy(box_t), torch.from_numpy(num_pos), **kw)[0]
    total.backward()

    def f_flat(co):
        return jl.detection_loss_flat(
            jl.levels_to_flat(co, c), jl.levels_to_flat(box_out, 4), cls_t,
            box_t, num_pos, **kw)[0]
    value, grads = jax.value_and_grad(f_flat)([jnp.asarray(a)
                                               for a in cls_out])
    np.testing.assert_allclose(float(total.detach()), float(value), rtol=2e-5)
    for t, g in zip(tc, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-7)


def test_fused_focal_bf16_matches_jax_custom_vjp():
    """In bf16, the autograd Function against JAX's custom VJP on the same
    bf16 logits: the value to rtol 1e-2 (summed in f32 from bf16 terms
    rounded at other places), the bf16 gradient to two bf16 steps."""
    rng = np.random.default_rng(4)
    logits = rng.normal(-3, 2, (2, 4, 4, 3, 7)).astype(np.float32)
    tgt = rng.integers(-2, 7, (2, 4, 4, 3)).astype(np.int32)
    x = torch.from_numpy(logits).to(torch.bfloat16).requires_grad_()
    norm = torch.tensor(5.0)
    value = tl.FusedAlphaFocalSum.apply(x, torch.from_numpy(tgt), norm, 0.15,
                                        0.0)
    value.backward()
    jx = jnp.asarray(logits).astype(jnp.bfloat16)
    jvalue, jgrad = jax.value_and_grad(
        lambda v: jl.fused_alpha_focal_sum((0.15, 0.0, 7), v,
                                           jnp.asarray(tgt),
                                           jnp.float32(5.0)))(jx)
    assert value.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(value.detach()), float(jvalue), rtol=1e-2)
    np.testing.assert_allclose(_np(x.grad), np.asarray(jgrad, np.float32),
                               rtol=2 ** -7, atol=2 ** -10)


@pytest.mark.parametrize("legacy", [False, True])
def test_remat_cls_grads_equal_plain_grads(legacy):
    """remat_cls (torch.utils.checkpoint around each level's class loss)
    recomputes the same operations: values and gradients bit-identical."""
    rng = np.random.default_rng(5)
    cls_out, box_out, cls_t, box_t, num_pos = _nhwc_inputs(rng)
    kw = dict(num_classes=7, alpha=0.25, gamma=1.5, delta=0.1,
              box_loss_weight=50.0, label_smoothing=0.01, legacy_focal=legacy)
    results = []
    for remat in (True, False):
        tc = [torch.from_numpy(a).requires_grad_() for a in cls_out]
        total = tl.detection_loss_nhwc(
            tc, [torch.from_numpy(a) for a in box_out],
            torch.from_numpy(cls_t), torch.from_numpy(box_t),
            torch.from_numpy(num_pos), remat_cls=remat, **kw)[0]
        total.backward()
        results.append((total.detach(), [t.grad for t in tc]))
    (v1, g1), (v2, g2) = results
    assert torch.equal(v1, v2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


def test_detection_loss_class_matches_jax():
    """DetectionLoss on per-level lists and on flat arrays."""
    from ood_object_detection_tpu.config import (
        get_efficientdet_config as jax_cfg)
    from ood_object_detection_tpu_torch.config import get_efficientdet_config
    rng = np.random.default_rng(6)
    b, c, a, shapes = 2, 5, 9, [(8, 8), (4, 4)]
    cls_out = [rng.normal(0, 1, (b, h, w, a * c)).astype(np.float32)
               for h, w in shapes]
    box_out = [rng.normal(0, 1, (b, h, w, a * 4)).astype(np.float32)
               for h, w in shapes]
    cls_t = [rng.integers(-1, c, (b, h, w, a)).astype(np.int32)
             for h, w in shapes]
    box_t = [rng.normal(0, 1, (b, h, w, a * 4)).astype(np.float32)
             for h, w in shapes]
    num_pos = np.array([3.0, 5.0], np.float32)
    ours = tl.DetectionLoss(get_efficientdet_config(
        "efficientdet_d0", num_classes=c))(
        *([torch.from_numpy(x) for x in v] for v in
          (cls_out, box_out, cls_t, box_t)), torch.from_numpy(num_pos))
    ref = jl.DetectionLoss(jax_cfg("efficientdet_d0", num_classes=c))(
        cls_out, box_out, cls_t, box_t, num_pos)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(float(o), float(r), rtol=2e-5)


@pytest.mark.parametrize("margin", [0.0, 0.2])
def test_cosine_loss_matches_jax(margin):
    rng = np.random.default_rng(11)
    inputs = rng.uniform(-1, 1, (4, 50)).astype(np.float32)
    targets = (rng.uniform(size=(4, 50)) > 0.6).astype(np.float32)
    got = tl.cosine_loss(torch.from_numpy(inputs), torch.from_numpy(targets),
                         margin)
    want = jl.cosine_loss(jnp.asarray(inputs), jnp.asarray(targets), margin)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("loss", ["smooth_l1", "l2"])
def test_smooth_l1_and_l2_match_jax(loss, weighted):
    """The reference's regression losses, with the weighted-sign sums when
    weighted; smooth-L1 at its default beta and at beta 0 (plain L1)."""
    rng = np.random.default_rng(12)
    a, b = (rng.normal(0, 0.3, (3, 40, 4)).astype(np.float32)
            for _ in range(2))
    w = (rng.uniform(size=(3, 40, 4)) > 0.5).astype(np.float32)
    extra = [{}] if loss == "l2" else [{}, {"beta": 0.0}]
    for kw in extra:
        args_t = [torch.from_numpy(a), torch.from_numpy(b)]
        args_j = [jnp.asarray(a), jnp.asarray(b)]
        if weighted:
            kw = dict(kw, weights=None)
            kw_t = dict(kw, weights=torch.from_numpy(w))
            kw_j = dict(kw, weights=jnp.asarray(w))
        else:
            kw_t = kw_j = kw
        got = getattr(tl, f"{loss}_loss")(*args_t, **kw_t)
        want = getattr(jl, f"{loss}_loss")(*args_j, **kw_j)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want) == (3 if weighted else 1)
        for g, r in zip(got, want):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=2e-5,
                                       atol=1e-6)


def _level_case(rng, num_classes=5, batch=2, sizes=(8, 4, 2), anchors=3):
    cls_out, box_out, cls_t, box_t = [], [], [], []
    for s in sizes:
        cls_out.append(rng.normal(-2, 1.5, (batch, s, s, anchors
                                            * num_classes)))
        box_out.append(rng.normal(0, 0.3, (batch, s, s, anchors * 4)))
        t = rng.integers(-2, num_classes, (batch, s, s, anchors))
        cls_t.append(t.astype(np.int32))
        bt = rng.normal(0, 0.3, (batch, s, s, anchors * 4))
        bt[np.repeat(t < 0, 4, axis=-1)] = 0.0
        box_t.append(bt)
    f32 = lambda xs: [x.astype(np.float32) for x in xs]
    return f32(cls_out), f32(box_out), cls_t, f32(box_t)


@pytest.mark.parametrize("legacy", [False, True])
def test_detection_loss_levels_matches_jax(legacy):
    rng = np.random.default_rng(13)
    cls_out, box_out, cls_t, box_t = _level_case(rng)
    npos = np.array([5.0, 3.0], np.float32)
    kw = dict(num_classes=5, alpha=0.25, gamma=1.5, delta=0.1,
              box_loss_weight=50.0, label_smoothing=0.1, legacy_focal=legacy)
    tt = lambda xs: [torch.from_numpy(x) for x in xs]
    jj = lambda xs: [jnp.asarray(x) for x in xs]
    got = tl.detection_loss_levels(tt(cls_out), tt(box_out), tt(cls_t),
                                   tt(box_t), torch.from_numpy(npos), **kw)
    want = jl.detection_loss_levels(jj(cls_out), jj(box_out), jj(cls_t),
                                    jj(box_t), jnp.asarray(npos), **kw)
    for g, r in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=2e-5)


@pytest.mark.parametrize("loss_type", ["ce", "mse"])
@pytest.mark.parametrize("alpha", [None, 0.25])
def test_class_loss_flat_matches_jax(loss_type, alpha):
    rng = np.random.default_rng(14)
    logits = rng.normal(-2, 1.5, (2, 60, 4)).astype(np.float32)
    targets = rng.uniform(size=(2, 60, 4)).astype(np.float32)
    npos = np.array([4.0, 7.0], np.float32)
    got = tl.class_loss_flat(torch.from_numpy(logits),
                             torch.from_numpy(targets),
                             torch.from_numpy(npos), alpha, 1.5, 0.1,
                             loss_type)
    want = jl.class_loss_flat(jnp.asarray(logits), jnp.asarray(targets),
                              jnp.asarray(npos), alpha, 1.5, 0.1, loss_type)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5)


def test_box_only_loss_flat_matches_jax():
    rng = np.random.default_rng(15)
    box = rng.normal(0, 0.3, (2, 60, 4)).astype(np.float32)
    target = rng.normal(0, 0.3, (2, 60, 4)).astype(np.float32)
    target[:, ::3] = 0.0
    npos = np.array([4.0, 7.0], np.float32)
    got = tl.box_only_loss_flat(torch.from_numpy(box),
                                torch.from_numpy(target),
                                torch.from_numpy(npos), 0.1, 50.0)
    want = jl.box_only_loss_flat(jnp.asarray(box), jnp.asarray(target),
                                 jnp.asarray(npos), 0.1, 50.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5)
