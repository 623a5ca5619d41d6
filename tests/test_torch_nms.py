"""K1's plain version (ops/nms.py, what the CUDA kernel is held to) and the
kernel wrapper's CPU path vs the JAX package's lax NMS and its Pallas
kernel in interpret mode. Keep indices are held equal; scores to rtol 1e-6
(hard) and 1e-4 (soft), as tests/test_pallas_nms.py holds the Pallas
kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.ops.nms import nms_fixed as jax_nms
from ood_object_detection_tpu.ops.nms import soft_nms_fixed as jax_soft_nms
from ood_object_detection_tpu.ops.pallas_nms import pallas_batched_nms
from ood_object_detection_tpu_torch.ops import cuda_nms
from ood_object_detection_tpu_torch.ops.nms import nms_fixed, soft_nms_fixed


def _boxes(rng, b, n, ties=False, zero_rows=()):
    x1 = rng.uniform(0, 300, (b, n))
    y1 = rng.uniform(0, 300, (b, n))
    boxes = np.stack([x1, y1, x1 + rng.uniform(5, 60, (b, n)),
                      y1 + rng.uniform(5, 60, (b, n))], -1).astype(np.float32)
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    if ties:                      # many exactly equal scores
        scores = np.round(scores * 8) / 8
    scores[list(zero_rows)] = 0.0
    return boxes, scores


CASES = {
    "random": dict(b=3, n=300),
    "ties": dict(b=3, n=300, ties=True),
    "zero_row": dict(b=3, n=200, zero_rows=(1,)),
    "odd_n": dict(b=2, n=1001),
}


def _jax_ref(boxes, scores, max_out, mode, thr):
    if mode == "hard":
        fn = lambda b, s: jax_nms(b, s, thr, max_out)
    else:
        fn = lambda b, s: jax_soft_nms(b, s, max_out,
                                       method_gaussian=mode == "gaussian",
                                       iou_threshold=thr)
    ki, ks = jax.jit(jax.vmap(fn))(jnp.asarray(boxes), jnp.asarray(scores))
    return np.asarray(ki), np.asarray(ks)


def _port(boxes, scores, max_out, mode, thr):
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    if mode == "hard":
        ki, ks = nms_fixed(b, s, thr, max_out)
    else:
        ki, ks = soft_nms_fixed(b, s, max_out,
                                method_gaussian=mode == "gaussian",
                                iou_threshold=thr)
    return ki.numpy(), ks.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["hard", "gaussian", "linear"])
def test_plain_nms_matches_jax(case, mode):
    rng = np.random.default_rng(sorted(CASES).index(case))
    boxes, scores = _boxes(rng, **CASES[case])
    ki, ks = _port(boxes, scores, 60, mode, 0.3)
    ki_ref, ks_ref = _jax_ref(boxes, scores, 60, mode, 0.3)
    np.testing.assert_array_equal(ki, ki_ref)
    np.testing.assert_allclose(ks, ks_ref, rtol=1e-6 if mode == "hard" else 1e-4)
    if case == "zero_row":
        assert (ki[1] == -1).all() and (ks[1] == 0).all()


@pytest.mark.parametrize("soft", [False, True])
def test_kernel_wrapper_cpu_matches_pallas_interpret(soft):
    """The K1 wrapper on CPU tensors (its plain version) vs the Pallas
    kernel it replaces, run in interpret mode."""
    rng = np.random.default_rng(5)
    boxes, scores = _boxes(rng, 2, 333, ties=True)
    cuda_nms.batched_nms.launches = 0
    ki, ks = cuda_nms.batched_nms(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), max_out=50,
                                  iou_threshold=0.3, soft=soft)
    assert cuda_nms.batched_nms.launches == 0     # CPU: no kernel launched
    ki_p, ks_p = pallas_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                    max_out=50, iou_threshold=0.3, soft=soft)
    np.testing.assert_array_equal(ki.numpy(), np.asarray(ki_p))
    np.testing.assert_allclose(ks.numpy(), np.asarray(ks_p),
                               rtol=1e-4 if soft else 1e-6)


def test_padding_rows():
    boxes = torch.tensor([[[0, 0, 10, 10], [100, 100, 110, 110]]],
                         dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.0]])
    ki, ks = cuda_nms.batched_nms(boxes, scores, max_out=4, iou_threshold=0.5)
    np.testing.assert_array_equal(ki.numpy()[0], [0, -1, -1, -1])
    np.testing.assert_allclose(ks.numpy()[0], [0.9, 0, 0, 0])


@pytest.mark.parametrize("batch, sms, cluster", [
    (16, 132, 8), (128, 132, 1), (32, 132, 4), (64, 132, 2), (200, 132, 1)])
def test_cluster_size_fills_the_sms(batch, sms, cluster):
    """K1 spreads an image over a cluster of C CTAs: the largest portable
    C with B * C <= SMs."""
    assert cuda_nms.cluster_size(batch, sms) == cluster


def test_cluster_size_keeps_every_image_resident():
    """A cluster size whose clusters do not all fit on the card at once
    (a second wave) is passed over for the next smaller one."""
    resident = {1: 132, 2: 66, 4: 30, 8: 30}.get
    assert cuda_nms.cluster_size(16, 132, resident) == 8
    assert cuda_nms.cluster_size(32, 132, resident) == 2
    assert cuda_nms.cluster_size(30, 132, resident) == 4
    assert cuda_nms.cluster_size(64, 132, resident) == 2
    assert cuda_nms.cluster_size(128, 132, resident) == 1
    assert cuda_nms.cluster_size(16, 132, lambda c: 0) == 1


@pytest.mark.parametrize("cluster, accepted", [
    (0, False), (3, False), (6, False), (16, False), (32, False),
    (1, True), (2, True), (4, True), (8, True)])
def test_forced_cluster_refusals(cluster, accepted):
    """A forced cluster size must be a power of two up to the portable 8
    (the grid is B * C blocks, so it divides the grid); any other is
    refused before the device dispatch, and those are accepted."""
    boxes, scores = _boxes(np.random.default_rng(0), 1, 10)
    b, s = torch.from_numpy(boxes), torch.from_numpy(scores)
    if accepted:
        ki, ks = cuda_nms.batched_nms(b, s, max_out=4, cluster=cluster)
        assert ki.shape == ks.shape == (1, 4)
    else:
        with pytest.raises(ValueError, match="cluster size"):
            cuda_nms.batched_nms(b, s, cluster=cluster)
