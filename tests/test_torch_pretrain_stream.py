"""``data.pretrain_stream`` of the port against the JAX package's: the
cases of ``tests/test_pretrain_stream.py`` on the port, the category
split equal to JAX's, and the first 8 batches of a
``PretrainEpisodeStream`` over a ``SyntheticEpisodeSource`` bit-equal to
JAX's (uint8 images, boxes, classes and the val flag), with and without
``random_trans`` (whose jitter draws from Python's global ``random``,
seeded alike before each side). Host code only: no tolerance."""
import random

import numpy as np
import pytest

from ood_object_detection_tpu.data import episodic as jax_episodic
from ood_object_detection_tpu.data import pretrain_stream as jax_stream
from ood_object_detection_tpu_torch.data import (PretrainEpisodeStream,
                                                 SyntheticEpisodeSource,
                                                 split_categories_by_count)


def test_split_categories_by_count():
    counts = {1: 100, 2: 5, 3: 50, 4: 20}
    train, val = split_categories_by_count(counts, 2, 2)
    assert train == [1, 3]
    assert val == [4, 2]


def test_split_matches_jax_with_ties():
    counts = {int(c): int(n) for c, n in enumerate(
        np.random.default_rng(0).integers(1, 6, 40), start=1)}
    for n_train, n_val in ((10, 5), (26, 14), (3, 0)):
        assert split_categories_by_count(counts, n_train, n_val) == \
            jax_stream.split_categories_by_count(counts, n_train, n_val)


def test_stream_yields_fixed_shape_batches():
    src = SyntheticEpisodeSource(num_cats=4, img_hw=(64, 64))
    stream = PretrainEpisodeStream(
        src, (64, 64), train_cats=[1, 2, 3], val_cats=[4],
        num_qry=4, val_freq=3, num_val_batches=1)
    it = iter(stream)
    batches = [next(it) for _ in range(6)]
    for b in batches:
        assert b["image"].shape == (4, 64, 64, 3)
        assert b["bbox"].shape == (4, 100, 4)
        assert b["cls"].shape == (4, 100)
    # val block interleaved at step 3
    val_flags = [b["val_iter"] for b in batches]
    assert any(val_flags) and not all(val_flags)


def test_stream_train_val_categories_disjoint():
    src = SyntheticEpisodeSource(num_cats=4, img_hw=(64, 64))
    stream = PretrainEpisodeStream(
        src, (64, 64), train_cats=[1, 2], val_cats=[3, 4],
        num_qry=4, val_freq=2, num_val_batches=1)
    it = iter(stream)
    for _ in range(8):
        b = next(it)
        cats = set(np.unique(b["cls"][b["cls"] > 0]))
        if b["val_iter"]:
            assert cats <= {3, 4}, cats
        else:
            assert cats <= {1, 2}, cats


def test_random_trans_default_letterboxes_train_items():
    """preloader.py:71-76: train items use the EVAL letterbox unless
    random_trans; the flag swaps in jitter+flip."""
    src = SyntheticEpisodeSource(num_cats=3, img_hw=(64, 64))
    stream = PretrainEpisodeStream(src, (64, 64), [1, 2], [3], num_qry=2)
    assert stream.train_tf is stream.eval_tf
    aug = PretrainEpisodeStream(src, (64, 64), [1, 2], [3], num_qry=2,
                                random_trans=True)
    assert aug.train_tf is not aug.eval_tf
    batch = next(iter(aug))
    assert batch["image"].shape == (2, 64, 64, 3)


def _first_batches(source_cls, stream_cls, random_trans, count=8):
    random.seed(1234)
    src = source_cls(num_cats=5, img_hw=(96, 80), seed=3)
    stream = stream_cls(src, (64, 64), train_cats=[1, 2, 3],
                        val_cats=[4, 5], num_qry=3, val_freq=3,
                        num_val_batches=2, seed=5, random_trans=random_trans)
    it = iter(stream)
    return [next(it) for _ in range(count)]


@pytest.mark.parametrize("random_trans", [False, True])
def test_first_batches_bit_equal_to_jax(random_trans):
    want = _first_batches(jax_episodic.SyntheticEpisodeSource,
                          jax_stream.PretrainEpisodeStream, random_trans)
    got = _first_batches(SyntheticEpisodeSource, PretrainEpisodeStream,
                         random_trans)
    assert [b["val_iter"] for b in got] == [b["val_iter"] for b in want]
    assert any(b["val_iter"] for b in got)
    for g, w in zip(got, want):
        assert g["image"].dtype == np.uint8
        for key in ("image", "bbox", "cls"):
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
