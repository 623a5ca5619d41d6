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


def _level_shapes(img, batch):
    """D0 class-head output shapes [B, H, W, 9*C] of levels P3..P7."""
    return [(batch, img >> lvl, img >> lvl, 9 * C) for lvl in range(3, 8)]


@pytest.mark.parametrize("img", [512, 128])
@pytest.mark.parametrize("batch", [1, 3, 16])
def test_tile_plan_covers_every_anchor_once(img, batch):
    """K2's one launch walks tiles of all five levels: together they cover
    every anchor row of every level exactly once, each starts 16-byte
    aligned, only a level's last tile may be ragged (read in place), and
    the levels' columns add up to A_total."""
    shapes = _level_shapes(img, batch)
    plan = cuda_reduce.tile_plan(shapes, C)
    per_image = [h * w * 9 for _, h, w, _ in shapes]
    assert plan.a_total == sum(per_image) == sum(plan.rows_per_image)
    assert list(plan.col_offsets) == list(np.cumsum([0] + per_image[:-1]))
    assert plan.tile_rows % 8 == 0 and plan.row_bytes == 2 * C
    seen = [np.zeros(batch * n, dtype=np.int64) for n in per_image]
    last = {}
    for level, row0, rows, offset, bulk in cuda_reduce.plan_tiles(plan):
        assert 0 < rows <= plan.tile_rows
        assert offset % 16 == 0 and offset == row0 * 2 * C
        assert bulk == (rows * 2 * C % 16 == 0)
        if not bulk:
            assert row0 + rows == plan.rows[level]    # the level's last tile
        seen[level][row0:row0 + rows] += 1
        last[level] = max(last.get(level, 0), row0 + rows)
    assert all((s == 1).all() for s in seen)
    assert [last[l] for l in range(5)] == [batch * n for n in per_image]
    if img == 128 and batch == 3:       # P7: 27 rows of 180 B, ragged
        assert plan.rows[4] == 27 and 27 * 2 * C % 16


def test_tile_plan_refusals():
    with pytest.raises(ValueError, match="batch"):
        cuda_reduce.tile_plan([(2, 4, 4, 9 * C), (3, 2, 2, 9 * C)], C)
    with pytest.raises(ValueError, match="levels"):
        cuda_reduce.tile_plan([(1, 2, 2, 9 * C)] * 9, C)
    with pytest.raises(ValueError, match="A\\*C"):
        cuda_reduce.tile_plan([(1, 2, 2, 9 * C + 1)], C)


def test_rejects_misaligned_level():
    """The kernel bulk-copies each level from its base, which must be
    16-byte aligned; the wrapper refuses a level that is not, on any
    device, before it dispatches."""
    n = 2 * 2 * 9 * C
    flat = torch.zeros(n + 1, dtype=torch.bfloat16)
    level = flat[1:].view(1, 2, 2, 9 * C)         # 2 bytes past the base
    assert level.is_contiguous() and level.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        cuda_reduce.key_energy_reduce([level], C, True)
    aligned = flat[:n].view(1, 2, 2, 9 * C)
    key, energy = cuda_reduce.key_energy_reduce([aligned], C, True)
    assert key.shape == energy.shape == (1, 36)
