"""The port's five custom operators (namespace ``ood_detection``): K1
``batched_nms``, K2 ``key_energy_reduce``, K3 ``batch_match``, K4
``batch_codes_targets`` and the letterbox ``letterbox_normalize``.

- ``torch.library.opcheck`` on CPU inputs: the schema, the fake
  implementation's shapes and dtypes against the real one, and the
  dispatch under ``torch.compile``'s tracing.
- Each public wrapper is its plain version, bit for bit, on the CPU.
- On fake (meta) tensors the operators give shapes alone, which is what
  ``torch.export`` records.
- The CUDA implementation of each kernel launches or raises: given tensors
  that are not on one CUDA device it refuses them, and never runs the plain
  version.
"""
import numpy as np
import pytest
import torch
from torch.library import opcheck

from ood_object_detection_tpu_torch.data import device_preproc
from ood_object_detection_tpu_torch.ops import (cuda_labeler, cuda_nms,
                                                cuda_reduce)
from ood_object_detection_tpu_torch.ops.nms import batched_nms_plain

C = 8


def _nms_inputs(seed=0, b=2, n=300):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (b, n, 2))
    wh = rng.uniform(5, 30, (b, n, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(np.round(rng.uniform(0, 1, (b, n)) * 8) / 8
                              ).to(torch.float32)               # ties
    return boxes, scores


def _levels(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(-3, 2, (b, s, s, 9 * C))
                             .astype(np.float32)).to(torch.bfloat16)
            for s in (8, 4, 2)]


def _label_inputs(seed=0, b=2, m=6, a=400):
    rng = np.random.default_rng(seed)
    yx = rng.uniform(0, 100, (a, 2))
    anchors = torch.from_numpy(np.concatenate(
        [yx, yx + rng.uniform(8, 30, (a, 2))], -1).astype(np.float32))
    gyx = rng.uniform(0, 100, (b, m, 2))
    gt = torch.from_numpy(np.concatenate(
        [gyx, gyx + rng.uniform(8, 30, (b, m, 2))], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(b, m)) < 0.7)
    valid[:, 0] = True
    classes = torch.from_numpy(rng.integers(1, 5, (b, m)).astype(np.int32))
    return anchors, gt, valid, classes


def _op_cases():
    boxes, scores = _nms_inputs()
    anchors, gt, valid, classes = _label_inputs()
    vals, rows, best = cuda_labeler.batch_match_plain(anchors, gt, valid)
    canvases = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 40, 48, 3), dtype=np.uint8))
    true_hw = torch.tensor([[40, 48], [31, 23]], dtype=torch.int32)
    stats = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225],
             [124.0, 116.0, 104.0])
    return {
        "batched_nms_hard": ("batched_nms", (boxes, scores, 50, 0.3, False,
                                             0.5, 0.001, None)),
        "batched_nms_soft": ("batched_nms", (boxes, scores, 50, 0.3, True,
                                             0.5, 0.001, None)),
        "key_energy_reduce": ("key_energy_reduce", (_levels(), C, True)),
        "key_energy_reduce_keys_only": ("key_energy_reduce",
                                        (_levels(1), C, False)),
        "batch_match": ("batch_match", (anchors, gt, valid)),
        "batch_codes_targets": ("batch_codes_targets",
                                (anchors, gt, classes, valid, vals, rows,
                                 best, 0.5, 0.4)),
        "letterbox_normalize_f32": ("letterbox_normalize",
                                    (canvases, true_hw, 32, 32, *stats,
                                     "float32")),
        "letterbox_normalize_bf16": ("letterbox_normalize",
                                     (canvases, true_hw, 24, 40, *stats,
                                      "bfloat16")),
    }


CASES = _op_cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    name, args = CASES[case]
    op = getattr(torch.ops.ood_detection, name).default
    opcheck(op, args)


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("soft", [False, True])
def test_nms_wrapper_is_its_plain_version(soft):
    boxes, scores = _nms_inputs(1)
    kw = dict(max_out=40, iou_threshold=0.4, soft=soft)
    assert _equal(cuda_nms.batched_nms(boxes, scores, **kw),
                  batched_nms_plain(boxes, scores, **kw))


@pytest.mark.parametrize("energy", [False, True])
def test_reduce_wrapper_is_its_plain_version(energy):
    levels = _levels(2)
    assert _equal(cuda_reduce.key_energy_reduce(levels, C, energy),
                  cuda_reduce.key_energy_reduce_plain(levels, C, energy))


def test_labeler_wrappers_are_their_plain_versions():
    anchors, gt, valid, classes = _label_inputs(4)
    match = cuda_labeler.batch_match(anchors, gt, valid)
    assert _equal(match, cuda_labeler.batch_match_plain(anchors, gt, valid))
    args = (anchors, gt, classes, valid, *match, 0.5, 0.4)
    assert _equal(cuda_labeler.batch_codes_targets(*args),
                  cuda_labeler.batch_codes_targets_plain(*args))


def test_letterbox_wrapper_matches_its_loop():
    """``batched_letterbox_normalize`` is the operator around the loop:
    the dict of its three outputs."""
    canvases = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (3, 50, 60, 3), dtype=np.uint8))
    true_hw = torch.tensor([[50, 60], [41, 23], [17, 60]], dtype=torch.int32)
    out = device_preproc.batched_letterbox_normalize(
        canvases, true_hw, target_hw=(64, 48), out_dtype="bfloat16")
    want = torch.ops.ood_detection.letterbox_normalize(
        canvases, true_hw, 64, 48, list(device_preproc.IMAGENET_DEFAULT_MEAN),
        list(device_preproc.IMAGENET_DEFAULT_STD), [124.0, 116.0, 104.0],
        "bfloat16")
    assert _equal((out["image"], out["img_scale"], out["img_size"]), want)


def test_meta_tensors_give_shapes_alone():
    """The fake implementations, as ``torch.export`` traces them."""
    boxes = torch.empty((5, 1000, 4), device="meta")
    keep, kept = cuda_nms.batched_nms(boxes, torch.empty((5, 1000),
                                                         device="meta"),
                                      max_out=30)
    assert keep.shape == kept.shape == (5, 30)
    assert (keep.dtype, kept.dtype) == (torch.int32, torch.float32)
    levels = [torch.empty((3, s, s, 9 * C), dtype=torch.bfloat16,
                          device="meta") for s in (8, 4)]
    key, energy = cuda_reduce.key_energy_reduce(levels, C, True)
    assert key.shape == energy.shape == (3, 9 * (64 + 16))
    assert cuda_reduce.key_energy_reduce(levels, C, False)[1] is None
    anchors = torch.empty((700, 4), device="meta")
    gt = torch.empty((3, 9, 4), device="meta")
    valid = torch.empty((3, 9), dtype=torch.bool, device="meta")
    vals, rows, best = cuda_labeler.batch_match(anchors, gt, valid)
    assert (vals.shape, rows.shape, best.shape) == ((3, 700), (3, 700),
                                                    (3, 9))
    out = cuda_labeler.batch_codes_targets(
        anchors, gt, torch.empty((3, 9), dtype=torch.int32, device="meta"),
        valid, vals, rows, best, 0.5, 0.4)
    assert [tuple(t.shape) for t in out] == [(3, 700), (3, 700),
                                             (3, 700, 4), (3,)]
    assert [t.dtype for t in out] == [torch.int32, torch.int32,
                                      torch.float32, torch.float32]
    pre = device_preproc.batched_letterbox_normalize(
        torch.empty((4, 30, 40, 3), dtype=torch.uint8, device="meta"),
        torch.empty((4, 2), dtype=torch.int32, device="meta"),
        target_hw=(32, 48), out_dtype="bfloat16")
    assert pre["image"].shape == (4, 32, 48, 3)
    assert pre["image"].dtype == torch.bfloat16
    assert pre["img_scale"].shape == (4, 1) and pre["img_size"].shape == (4, 2)


def test_cuda_implementations_refuse_what_is_not_on_the_card():
    """The CUDA implementation of each kernel operator launches or raises:
    tensors not on one CUDA device are refused, and the plain version is
    never run in its place."""
    boxes, scores = _nms_inputs()
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_nms._nms_cuda(boxes, scores, 10, 0.3, False, 0.5, 0.001, None)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_reduce._reduce_cuda(_levels(), C, True)
    anchors, gt, valid, classes = _label_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_labeler._match_cuda(anchors, gt, valid)
    vals, rows, best = cuda_labeler.batch_match_plain(anchors, gt, valid)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_labeler._targets_cuda(anchors, gt, classes, valid, vals, rows,
                                   best, 0.5, 0.4)


@pytest.mark.parametrize("name", ["batched_nms", "key_energy_reduce",
                                  "batch_match", "batch_codes_targets"])
def test_kernel_operators_have_a_cuda_implementation(name):
    """Each kernel's operator has a CPU and a CUDA implementation of its
    own (the plain version and the launch), and no other backend."""
    qualname = f"ood_detection::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualname, "CPU") and has(qualname, "CUDA")
    assert not has(qualname, "CompositeImplicitAutograd")
