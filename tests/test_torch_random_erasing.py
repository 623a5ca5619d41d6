"""``data.random_erasing`` of the port against the JAX package's.

The port draws from a ``torch.Generator``, not from jax's PRNG, so the
rectangles differ image by image; it is held to the JAX tests'
semantics (``tests/test_random_erasing.py``, on the port) and to the JAX
function's statistics: over 1,024 images at ``probability=0.5`` the mean
erased fraction of each mode lies within 3 standard errors (of the
difference of the two means) of JAX's. The loader erases its training
batches after normalising and leaves evaluation batches alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.data import random_erasing as jax_erasing
from ood_object_detection_tpu_torch.data import dataset
from ood_object_detection_tpu_torch.data.random_erasing import random_erasing


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture
def images(rng):
    return torch.from_numpy(rng.normal(0, 1, (4, 32, 32, 3))
                            .astype(np.float32))


def _changed(out, x):
    return (out != x).any(dim=-1)                 # [B, H, W]


def test_probability_zero_is_identity(images):
    out = random_erasing(images, _gen(0), probability=0.0)
    assert torch.equal(out, images)


def test_const_mode_erases_rectangle_with_zeros(images):
    out = random_erasing(images, _gen(1), probability=1.0, mode="const",
                         min_area=0.1, max_area=0.3)
    changed = _changed(out, images)
    for b in range(images.shape[0]):
        assert changed[b].sum() > 0, "every image must get an erase box"
        # erased pixels are exactly 0 (the post-normalize mean)
        assert bool((out[b][changed[b]] == 0.0).all())
        ys, xs = torch.where(changed[b])
        # the erased region is one solid rectangle
        assert bool(changed[b][ys.min():ys.max() + 1,
                               xs.min():xs.max() + 1].all())


def test_pixel_mode_fills_noise(images):
    out = random_erasing(images, _gen(2), probability=1.0, mode="pixel",
                         min_area=0.1, max_area=0.3)
    vals = out[0][_changed(out, images)[0]]
    # per-pixel noise: many distinct values, not a constant fill
    assert len(np.unique(vals.numpy().round(5))) > 10


def test_rand_mode_one_value_per_channel(images):
    out = random_erasing(images, _gen(3), probability=1.0, mode="rand",
                         min_area=0.1, max_area=0.3)
    region = out[0][_changed(out, images)[0]]         # [N, 3]
    assert region.shape[0] > 0
    # each channel is a single broadcast noise value
    for ch in range(3):
        assert len(torch.unique(region[:, ch])) == 1


def test_deterministic_under_same_generator_seed(images):
    a = random_erasing(images, _gen(7), probability=0.7)
    b = random_erasing(images, _gen(7), probability=0.7)
    assert torch.equal(a, b)
    c = random_erasing(images, _gen(8), probability=0.7)
    assert not torch.equal(a, c)


def test_max_count_multiple_boxes(images):
    out = random_erasing(images, _gen(4), probability=1.0, max_count=3,
                         min_area=0.02, max_area=0.1)
    assert _changed(out, images)[0].sum() > 0


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_erased_fraction_matches_jax(mode):
    n, size = 1024, 32
    x = np.random.default_rng(0).normal(0, 1, (n, size, size, 3)).astype(
        np.float32)
    kw = dict(probability=0.5, mode=mode, max_count=2)
    want = np.asarray(jax_erasing(jax.random.key(0), jnp.asarray(x), **kw))
    got = random_erasing(torch.from_numpy(x), _gen(0), **kw).numpy()
    frac_j = (want != x).any(-1).mean(axis=(1, 2))
    frac_t = (got != x).any(-1).mean(axis=(1, 2))
    se = np.sqrt(frac_j.var() / n + frac_t.var() / n)
    assert abs(frac_t.mean() - frac_j.mean()) < 3 * se, (
        frac_t.mean(), frac_j.mean(), se)
    # the share of images with any erase: 1 - (1 - p)^2
    hit_j, hit_t = (frac_j > 0).mean(), (frac_t > 0).mean()
    assert abs(hit_t - hit_j) < 3 * np.sqrt(0.1875 * 2 / n)


def test_loader_erases_only_training_batches():
    ds = dataset.SyntheticDetectionDataset(num_images=4, image_size=(32, 32))
    plain = list(dataset.PrefetchLoader(ds, 2, workers=1, device="cpu"))
    erased = list(dataset.PrefetchLoader(ds, 2, workers=1, device="cpu",
                                         re_prob=1.0, re_mode="const"))
    for p, e in zip(plain, erased):
        changed = (e["image"] != p["image"]).any(-1)
        assert bool(changed.flatten(1).any(1).all())
        assert bool((e["image"][changed] == 0).all())
        assert torch.equal(e["bbox"], p["bbox"])
    for training in (True, False):
        loader = dataset.create_loader(ds, (32, 32), 2, workers=1,
                                       is_training=training, re_prob=1.0,
                                       re_mode="const", device="cpu")
        out = list(loader)
        ref = list(dataset.PrefetchLoader(ds, 2, workers=1, device="cpu",
                                          shuffle=training,
                                          drop_last=training))
        same = [torch.equal(a["image"], b["image"]) for a, b in zip(out, ref)]
        assert not any(same) if training else all(same)
