"""K2's plain version (what the CUDA kernel is held to) vs the JAX
package's live XLA reduce ``_packed_f32_key_reduce`` and the Pallas kernel
``fused_key_ood_reduce`` in interpret mode, at D0@512 level shapes with
C = 90. The key is bit-exact; the energy agrees to f32 summation order
(rtol 1e-6, atol 1e-5)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import head_outputs, to_torch

from ood_object_detection_tpu.ops.pallas_reduce import fused_key_ood_reduce
from ood_object_detection_tpu.ops.post_process import (
    _packed_f32_key_reduce as jax_packed_reduce,
)
from ood_object_detection_tpu_torch.ops import cuda_reduce
from ood_object_detection_tpu_torch.ops.anchors import get_feat_sizes
from ood_object_detection_tpu_torch.ops.post_process import _unpack_f32_key

C = 90


@pytest.fixture(scope="module")
def d0_levels():
    rng = np.random.default_rng(11)
    cls, _ = head_outputs(get_feat_sizes((512, 512), 7), 3, 7, C, rng,
                          batch=1, cls_mean=-3.0, ties=True)
    # a few anchors with every class equal: the key must pick class 0
    cls[2][0, 1, 1, :C] = 0.5
    return cls


def _jax_levels(cls):
    return [jnp.asarray(c).astype(jnp.bfloat16) for c in cls]


def test_plain_matches_xla_reduce(d0_levels):
    key, energy = cuda_reduce.key_energy_reduce_plain(
        to_torch(d0_levels, torch.bfloat16), C, energy=True)
    key_ref, energy_ref = jax_packed_reduce(_jax_levels(d0_levels), C,
                                            ood_method="energy")
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_ref))
    np.testing.assert_allclose(energy.numpy(), np.asarray(energy_ref),
                               rtol=1e-6, atol=1e-5)


def test_wrapper_cpu_matches_pallas_interpret(d0_levels):
    levels = d0_levels[1:]          # P4..P7: keep the interpreter quick
    cuda_reduce.key_energy_reduce.launches = 0
    key, energy = cuda_reduce.key_energy_reduce(
        to_torch(levels, torch.bfloat16), C, energy=True)
    assert cuda_reduce.key_energy_reduce.launches == 0
    key_ref, energy_ref = fused_key_ood_reduce(
        _jax_levels(levels), C, ood_method="energy", interpret=True)
    np.testing.assert_array_equal(key.numpy(), np.asarray(key_ref))
    np.testing.assert_allclose(energy.numpy(), np.asarray(energy_ref),
                               rtol=1e-6, atol=1e-5)


def test_key_decodes_to_max_and_lowest_argmax(d0_levels):
    levels = to_torch(d0_levels[2:], torch.bfloat16)
    key, energy = cuda_reduce.key_energy_reduce_plain(levels, C, energy=False)
    assert energy is None
    logit, cls = _unpack_f32_key(key)
    rows = torch.cat([lvl.reshape(1, -1, C) for lvl in levels], dim=1)
    np.testing.assert_array_equal(logit.numpy(),
                                  rows.amax(-1).to(torch.float32).numpy())
    np.testing.assert_array_equal(cls.numpy(), rows.argmax(-1).numpy())
    tied = (1 * 16 + 1) * 9               # P5 (16 x 16) cell (1, 1), anchor 0
    assert cls[0, tied] == 0 and logit[0, tied] == 0.5


def test_rejects_f32_and_too_many_classes():
    with pytest.raises(TypeError):
        cuda_reduce.key_energy_reduce([torch.zeros(1, 2, 2, 9 * C)], C, True)
    with pytest.raises(ValueError):
        cuda_reduce.key_energy_reduce(
            [torch.zeros(1, 2, 2, 300, dtype=torch.bfloat16)], 300, False)
