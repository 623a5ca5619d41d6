"""The port's labeler (K3's and K4's plain versions, with the torch
thresholds and force-match inside K4's) against the JAX labeler on the
CPU: the Pallas kernels in interpret mode (``impl="pallas"``, as
tests/test_pallas_labeler.py runs them) and the vmapped XLA path
(``impl="xla"``), on D0's 3069 anchors at 128 px.

Match codes, class targets, num_positives, matched rows and best anchors
are held bit for bit. The port's IoU equals ``pairwise_iou_yxyx`` bit for
bit; the interpret-mode Pallas kernel rounds some IoUs up to three f32
steps differently depending on its block size (XLA's CPU code generation;
measured 2.95e-7 relative at block_t 512), so matched IoU values against
it are held to rtol 1e-6. Box
targets are held to rtol 1e-5 / atol 1e-6 (the division and log of the
encode may round in the last bit differently; tests/test_pallas_labeler.py
allows the TPU kernel the same).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.ops.boxes import pairwise_iou_yxyx as jax_iou
from ood_object_detection_tpu.ops.pallas_labeler import pallas_batch_match
from ood_object_detection_tpu.ops.pallas_labeler import (
    pallas_label_match as jax_label_match,
)
from ood_object_detection_tpu.ops.target_assigner import (
    AnchorLabeler as JaxLabeler,
)
from ood_object_detection_tpu.ops.target_assigner import (
    argmax_match as jax_argmax_match,
)
from ood_object_detection_tpu.ops.target_assigner import (
    batch_label_anchors as jax_batch_label_anchors,
)
from ood_object_detection_tpu.ops.target_assigner import (
    label_anchors as jax_label_anchors,
)
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.ops import cuda_labeler
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.ops.boxes import pairwise_iou_yxyx
from ood_object_detection_tpu_torch.ops.target_assigner import (
    AnchorLabeler,
    argmax_match,
    batch_label_anchors,
    label_anchors,
)

IMG = 128


@pytest.fixture(scope="module")
def anchors():
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=4).replace(
        image_size=(IMG, IMG))
    return Anchors.from_config(cfg)


def _batch(seed, b=4, m=16):
    """Random GT with a varying padded suffix per image, and the cases
    that decide ties: in image 0 two identical rows (force-match gives the
    shared best anchor to the lower row) and a row that overlaps no anchor
    (its row max is 0 at every anchor, so the lowest anchor is its best);
    the last image is all padding."""
    rng = np.random.default_rng(seed)
    yx = rng.uniform(0, IMG - 40, (b, m, 2)).astype(np.float32)
    hw = rng.uniform(8, 40, (b, m, 2)).astype(np.float32)
    boxes = np.concatenate([yx, yx + hw], -1)
    cls = rng.integers(1, 4, (b, m)).astype(np.int32)
    for i in range(b):
        k = rng.integers(0, m // 2)
        cls[i, m - k:] = -1
    boxes[0, 1] = boxes[0, 0]
    boxes[0, 2] = [1000.0, 1000.0, 1010.0, 1010.0]
    cls[0, :3] = [1, 2, 3]
    cls[-1] = -1
    return boxes, cls


def _jax_anchors(anchors):
    return jnp.asarray(anchors.boxes)


def _torch_anchors(anchors):
    return torch.from_numpy(anchors.boxes)


def test_pairwise_iou_matches_jax(anchors):
    boxes, _ = _batch(0)
    ours = pairwise_iou_yxyx(torch.from_numpy(boxes[0]),
                             _torch_anchors(anchors))
    ref = jax_iou(jnp.asarray(boxes[0]), _jax_anchors(anchors))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert (ours.numpy()[2] == 0).all()              # the far row


@pytest.mark.parametrize("block_t", [4096, 512])
def test_batch_match_matches_pallas(anchors, block_t):
    """K3's plain version against the Pallas kernel; block_t 512 splits the
    3069 anchors into 6 blocks, so JAX's earliest-block combine of the row
    maxima is held against the port's global reduce."""
    boxes, cls = _batch(1)
    valid = cls > -1
    vals, rows, best = cuda_labeler.batch_match(
        _torch_anchors(anchors), torch.from_numpy(boxes),
        torch.from_numpy(valid))
    jvals, jrows, jbest = pallas_batch_match(
        _jax_anchors(anchors), jnp.asarray(boxes), jnp.asarray(valid),
        block_t=block_t)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert best[0, 2] == 0               # no overlap: a tie at 0, anchor 0
    assert (vals[-1] == -1).all() and (best[-1] == 0).all()   # all padding


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("unmatched", [None, 0.3])
def test_label_result_matches_jax(anchors, impl, unmatched):
    """K3 -> label_match -> K4 (plain versions) against the JAX labeler,
    with and without the 0.3 / 0.5 ignore band."""
    boxes, cls = _batch(2)
    res = batch_label_anchors(_torch_anchors(anchors),
                              torch.from_numpy(boxes), torch.from_numpy(cls),
                              match_threshold=0.5,
                              unmatched_threshold=unmatched)
    ref = jax_batch_label_anchors(
        _jax_anchors(anchors), jnp.asarray(boxes), jnp.asarray(cls),
        match_threshold=0.5, unmatched_threshold=unmatched, impl=impl)
    np.testing.assert_array_equal(res.matches.numpy(), np.asarray(ref.matches))
    np.testing.assert_array_equal(res.cls_targets.numpy(),
                                  np.asarray(ref.cls_targets))
    np.testing.assert_array_equal(res.num_positives.numpy(),
                                  np.asarray(ref.num_positives))
    np.testing.assert_allclose(res.box_targets.numpy(),
                               np.asarray(ref.box_targets),
                               rtol=1e-5, atol=1e-6)
    codes = res.matches.numpy()
    assert (codes[-1] == -1).all() and res.num_positives[-1] == 0
    assert ((codes == -2).any() and (res.cls_targets.numpy() == -2).any()) \
        == (unmatched is not None)


def test_label_match_matches_pallas_label_match(anchors):
    """The torch thresholds + scatter-min force-match on K3's outputs
    against ``pallas_label_match``; the identical rows 0 and 1 of image 0
    share a best anchor, which row 0 takes."""
    boxes, cls = _batch(3)
    valid = torch.from_numpy(cls > -1)
    vals, rows, best = cuda_labeler.batch_match_plain(
        _torch_anchors(anchors), torch.from_numpy(boxes), valid)
    codes = cuda_labeler.label_match(vals, rows, best, valid, 0.5, 0.3)
    ref = jax_label_match(_jax_anchors(anchors), jnp.asarray(boxes),
                          jnp.asarray(cls), matched_threshold=0.5,
                          unmatched_threshold=0.3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
    assert best[0, 0] == best[0, 1]
    assert codes[0, best[0, 0]] == 0
    assert codes[0, best[0, 2]] == 2     # the far row still claims anchor 0


def test_batch_targets_matches_pallas_targets(anchors):
    """The targets half of K4's plain version (``batch_targets_plain``,
    which ``label_anchors`` also uses) against ``pallas_batch_targets`` on
    the same final codes."""
    from ood_object_detection_tpu.ops.pallas_labeler import (
        pallas_batch_targets)
    boxes, cls = _batch(4)
    res = batch_label_anchors(_torch_anchors(anchors),
                              torch.from_numpy(boxes), torch.from_numpy(cls),
                              unmatched_threshold=0.3)
    c, b = cuda_labeler.batch_targets_plain(
        _torch_anchors(anchors), torch.from_numpy(boxes),
        torch.from_numpy(cls), res.matches)
    jc, jb = pallas_batch_targets(_jax_anchors(anchors), jnp.asarray(boxes),
                                  jnp.asarray(cls),
                                  jnp.asarray(res.matches.numpy()))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("unmatched", [None, 0.3])
def test_batch_codes_targets_matches_pallas(anchors, unmatched):
    """K4's wrapper on CPU tensors (its plain version) from K3's outputs
    against ``pallas_label_match`` + ``pallas_batch_targets``: codes, class
    targets and positives bit for bit, box targets to rtol 1e-5."""
    from ood_object_detection_tpu.ops.pallas_labeler import (
        pallas_batch_targets)
    boxes, cls = _batch(8)
    valid = torch.from_numpy(cls > -1)
    t_anchors, t_boxes = _torch_anchors(anchors), torch.from_numpy(boxes)
    k3 = cuda_labeler.batch_match(t_anchors, t_boxes, valid)
    threshold = 0.5 if unmatched is None else unmatched
    codes, c, b, pos = cuda_labeler.batch_codes_targets(
        t_anchors, t_boxes, torch.from_numpy(cls), valid, *k3, 0.5,
        threshold)
    jcodes = jax_label_match(_jax_anchors(anchors), jnp.asarray(boxes),
                             jnp.asarray(cls), matched_threshold=0.5,
                             unmatched_threshold=threshold)
    jc, jb = pallas_batch_targets(_jax_anchors(anchors), jnp.asarray(boxes),
                                  jnp.asarray(cls), jcodes)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(
        pos.numpy(), (np.asarray(jcodes) >= 0).sum(axis=1).astype(np.float32))
    assert ((codes == -2).any() and (c == -2).any()) == (unmatched is not None)
    assert (codes[-1] == -1).all() and pos[-1] == 0        # all padding


@pytest.mark.parametrize("case", ["sixteen", "every", "last", "none"])
def test_batch_match_train_rows_matches_pallas(anchors, case):
    """K3's plain version against ``pallas_batch_match`` (block_t 512) at
    the train path's row count, M = 100: 16 valid rows an image as the
    train path pads them, every row valid, only the last row valid, and
    no row valid."""
    rng = np.random.default_rng(9)
    b, m = 2, 100
    yx = rng.uniform(0, IMG - 40, (b, m, 2)).astype(np.float32)
    hw = rng.uniform(8, 40, (b, m, 2)).astype(np.float32)
    boxes = np.concatenate([yx, yx + hw], -1)
    valid = np.zeros((b, m), bool)
    valid[:, {"sixteen": slice(0, 16), "every": slice(0, m),
              "last": slice(m - 1, m), "none": slice(0, 0)}[case]] = True
    vals, rows, best = cuda_labeler.batch_match(
        _torch_anchors(anchors), torch.from_numpy(boxes),
        torch.from_numpy(valid))
    jvals, jrows, jbest = pallas_batch_match(
        _jax_anchors(anchors), jnp.asarray(boxes), jnp.asarray(valid),
        block_t=512)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(best.numpy(), np.asarray(jbest))
    assert (best.numpy()[~valid] == 0).all()        # padded rows: anchor 0
    if case == "none":
        assert (vals == -1).all() and (rows == 0).all()
    if case == "last":
        assert (rows == m - 1).all()


@pytest.mark.parametrize("num_anchors", [1, 5, 8, 9, 3069, 49104])
def test_match_shares_cover_every_anchor_once(num_anchors):
    """K3's split of an image's anchors over its cluster: the CTAs' ranges
    follow each other in rank order and cover every anchor exactly once."""
    shares = cuda_labeler.match_shares(num_anchors)
    assert len(shares) == cuda_labeler.MATCH_CLUSTER
    assert shares[0][0] == 0 and shares[-1][1] == num_anchors
    for (lo, hi), (nxt, _) in zip(shares, shares[1:]):
        assert lo <= hi == nxt
    share = cuda_labeler.match_share(num_anchors)
    assert all(hi - lo <= share for lo, hi in shares)
    assert share * cuda_labeler.MATCH_CLUSTER >= num_anchors


@pytest.mark.parametrize("sim, unmatched, force", [
    ([[0.6, 0.4, 0.1, 0.55], [0.2, 0.7, 0.3, 0.0]], 0.5, False),
    ([[0.45, 0.6, 0.2]], 0.4, False),
    ([[0.6, 0.1, 0.05], [0.1, 0.2, 0.3]], 0.5, True),
    ([[0.3, 0.2], [0.3, 0.1], [0.3, 0.3]], 0.5, True),
])
def test_argmax_match_matches_jax(sim, unmatched, force):
    sim = np.asarray(sim, np.float32)
    valid = np.ones(sim.shape[0], bool)
    valid[-1] = sim.shape[0] < 3          # a padded last row in the 3x2 case
    ours = argmax_match(torch.from_numpy(sim), torch.from_numpy(valid), 0.5,
                        unmatched, force_match_for_each_row=force)
    ref = jax_argmax_match(jnp.asarray(sim), jnp.asarray(valid), 0.5,
                           unmatched, force_match_for_each_row=force)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("task_cls", [None, 2])
def test_label_anchors_single_image_matches_jax(anchors, task_cls):
    """One image through the [M, A] similarity path; with ``task_cls`` a
    near-duplicate of a task-class box (IoU > 0.9) is relabelled."""
    boxes, cls = _batch(5)
    boxes[1, 1] = boxes[1, 0] + np.float32(0.2)     # a near duplicate
    cls[1, :2] = [2, 3]
    res = label_anchors(_torch_anchors(anchors), torch.from_numpy(boxes[1]),
                        torch.from_numpy(cls[1]), task_cls=task_cls)
    ref = jax_label_anchors(_jax_anchors(anchors), jnp.asarray(boxes[1]),
                            jnp.asarray(cls[1]), task_cls=task_cls)
    np.testing.assert_array_equal(res.matches.numpy(), np.asarray(ref.matches))
    np.testing.assert_array_equal(res.cls_targets.numpy(),
                                  np.asarray(ref.cls_targets))
    assert float(res.num_positives) == float(ref.num_positives)
    np.testing.assert_allclose(res.box_targets.numpy(),
                               np.asarray(ref.box_targets),
                               rtol=1e-5, atol=1e-6)


def test_anchor_labeler_levels_with_task_cls(anchors):
    """AnchorLabeler.batch_label_anchors with task_cls: per-level targets
    and num_positives equal the JAX labeler's."""
    boxes, cls = _batch(6)
    boxes[0, 4] = boxes[0, 3] + np.float32(0.1)
    cls[0, 3:5] = [3, 1]
    jcfg = jax_cfg("efficientdet_d0", num_classes=4).replace(
        image_size=(IMG, IMG))
    ref = JaxLabeler(JaxAnchors.from_config(jcfg), 4).batch_label_anchors(
        boxes, cls, task_cls=3)
    ours = AnchorLabeler(anchors, 4).batch_label_anchors(
        torch.from_numpy(boxes), torch.from_numpy(cls), task_cls=3)
    for o, r in zip(ours[0], ref[0]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(ours[1], ref[1]):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))


def test_kernel_wrappers_take_the_plain_path_on_cpu(anchors):
    """CPU tensors run the plain versions and count no launch; the
    ``kernels=False`` switch gives the same labels."""
    boxes, cls = _batch(7)
    before = (cuda_labeler.batch_match.launches,
              cuda_labeler.batch_codes_targets.launches)
    args = (_torch_anchors(anchors), torch.from_numpy(boxes),
            torch.from_numpy(cls))
    a = batch_label_anchors(*args)
    b = batch_label_anchors(*args, kernels=False)
    assert (cuda_labeler.batch_match.launches,
            cuda_labeler.batch_codes_targets.launches) == before
    for f in ("matches", "cls_targets", "box_targets", "num_positives"):
        assert torch.equal(getattr(a, f), getattr(b, f))
