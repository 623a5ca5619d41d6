"""The port's ``layers.ResampleFeatureMap`` against the JAX package's, on
seeded NHWC maps of even and odd sizes.

- Downsampling by 2: ``max`` and ``avg`` pooling (kernel 3, stride 2)
  under TF-SAME and '' padding (flax ``avg_pool`` counts the padded zeros
  in the divisor, so the port pads explicitly), and by interpolation
  (``bilinear`` and ``bicubic`` through ``jax.image.resize``, which
  antialiases when it shrinks; ``nearest`` at half-pixel centres) to
  ``int(size / 2)``.
- Upsampling by 2: ``nearest`` (repeat) and ``bilinear`` (half-pixel
  centres).
- The 1x1 conv (+ BN) when the channels change, before or after a
  downsample (``conv_after_downsample``).

Tolerances, f32: max, nearest bit for bit; avg, bilinear and bicubic to
rtol = atol = 1e-6 (measured at most 4.2e-7: the frameworks weight and sum
in other orders); with the conv to 1e-5. bf16: within one bf16 step
(2^-7 relative and absolute; the port resamples in f32 and rounds once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables, to_numpy

from ood_object_detection_tpu.models import layers as jax_layers
from ood_object_detection_tpu_torch.models import layers
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

SIZES = ((9, 7), (8, 8), (5, 11))
EXACT = ("max", "nearest")


def _pair(in_ch, out_ch, dtype=jnp.float32, **kw):
    """(JAX module, its variables, the port module with them)."""
    jm = jax_layers.ResampleFeatureMap(in_ch, out_ch, dtype=dtype, **kw)
    variables = random_variables(
        lambda k: jm.init(k, jnp.zeros((1, 16, 16, in_ch), dtype)), 0)
    tm = layers.ResampleFeatureMap(in_ch, out_ch, **kw)
    if variables:
        load_jax_variables(tm, variables)
    return jm, variables, tm.eval()


def _run(jm, variables, tm, x, torch_dtype=torch.float32):
    want = np.asarray(jm.apply(variables, jnp.asarray(x).astype(
        jnp.bfloat16 if torch_dtype == torch.bfloat16 else jnp.float32)),
        np.float32)
    xt = torch.from_numpy(x).to(torch_dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = to_numpy(tm(xt.contiguous(memory_format=torch.channels_last))
                       .permute(0, 2, 3, 1))
    assert got.shape == want.shape
    return got, want


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pad_type", ["", "same"])
@pytest.mark.parametrize("mode", ["max", "avg", "bilinear", "bicubic",
                                  "nearest"])
def test_downsample_matches_jax(mode, pad_type, size):
    x = np.random.default_rng(1).normal(0, 1, (2, *size, 4)).astype(
        np.float32)
    got, want = _run(*_pair(4, 4, reduction_ratio=2, pad_type=pad_type,
                            downsample=mode), x)
    if mode in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_upsample_matches_jax(mode, size):
    x = np.random.default_rng(2).normal(0, 1, (2, *size, 4)).astype(
        np.float32)
    got, want = _run(*_pair(4, 4, reduction_ratio=0.5, upsample=mode), x)
    if mode in EXACT:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["avg", "bilinear"])
def test_bf16_resample_within_a_step(mode):
    x = np.random.default_rng(3).normal(0, 1, (2, 9, 7, 4)).astype(
        np.float32)
    kw = dict(reduction_ratio=2, downsample=mode) if mode == "avg" else \
        dict(reduction_ratio=0.5, upsample=mode)
    got, want = _run(*_pair(4, 4, dtype=jnp.bfloat16, **kw), x,
                     torch.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("after", [False, True])
@pytest.mark.parametrize("mode", ["avg", "bilinear"])
def test_channel_projection_around_the_resample(mode, after):
    x = np.random.default_rng(4).normal(0, 1, (2, 9, 7, 6)).astype(
        np.float32)
    got, want = _run(*_pair(6, 4, reduction_ratio=2, downsample=mode,
                            apply_bn=True, conv_after_downsample=after), x)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
