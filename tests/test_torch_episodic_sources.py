"""The episode sources of the port's ``data.episodic`` (and
``data.metadata``) against the JAX package's.

The cases of ``tests/test_episodic.py`` run on the port (composition of
an n-way episode, binary query labels, ``task_cls``, val categories, the
metadata loader, ``directory_support_source``, the prefetcher's order,
termination and error relay, the ``random_trans`` / ``supp_aug``
toggles), and the laziness of ``QuerySupportFallback``
(``tests/test_meta_real_data.py``). Then 4 episodes of the port's
``EpisodicDataset`` (one a val episode) and a ``known_eval_episode``
against JAX's at the same seed: the task categories and val flag equal,
the normalised images within 1e-6 (the projection crops' jitter draws
from Python's global ``random``, seeded alike before each side), the
class targets, positives, ground truth and task class bit-equal, the box targets to rtol 1e-5 / atol 1e-6
(slice 5's tolerance for the episode builder: the encoding's log). The
port builds on the CPU here (the plain versions of K3 / K4).
"""
import random

import numpy as np
import pytest
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data import episodic as jax_episodic
from ood_object_detection_tpu.meta.config import MetaConfig as JaxMeta
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.data import episodic as port_episodic
from ood_object_detection_tpu_torch.data.episodic import (
    EpisodePrefetcher, EpisodicDataset, QuerySupportFallback,
    SyntheticEpisodeSource)
from ood_object_detection_tpu_torch.meta.config import MetaConfig

N_WAY, NUM_SUP, NUM_QRY, NUM_ZERO, NUM_CATS = 3, 2, 2, 1, 8


@pytest.fixture(scope="module")
def ds():
    meta_cfg = MetaConfig(
        n_way=N_WAY, num_sup=NUM_SUP, num_qry=NUM_QRY,
        num_zero_images=NUM_ZERO, img_size=128, qry_img_size=128,
        supp_level_offset=2)
    model_cfg = get_efficientdet_config(
        "efficientdet_d0", num_classes=1, image_size=(128, 128))
    src = SyntheticEpisodeSource(num_cats=NUM_CATS, img_hw=(128, 128), seed=0)
    cats = list(range(1, NUM_CATS + 1))
    return EpisodicDataset(
        src.support_source(cats), src, model_cfg, meta_cfg,
        train_cats=cats[:5], val_cats=cats[5:], val_freq=0, seed=0,
        device="cpu")


@pytest.fixture(scope="module")
def episode(ds):
    return ds._episode(val_iter=False)


def test_nway_episode_composition(episode):
    assert episode["supp_images"].shape[0] == N_WAY * NUM_SUP
    assert episode["qry_images"].shape[0] == N_WAY * NUM_QRY + NUM_ZERO
    assert episode["proj_images"].shape[0] == N_WAY * NUM_QRY
    assert len(episode["task_cats"]) == N_WAY
    assert len(set(episode["task_cats"])) == N_WAY
    lab = episode["supp_cls_lab"].numpy()
    assert lab.shape == (N_WAY * NUM_SUP, N_WAY)
    np.testing.assert_array_equal(lab.sum(axis=1), np.ones(len(lab)))
    assert set(np.argmax(lab, axis=1)) == set(range(N_WAY))
    np.testing.assert_array_equal(np.sort(lab.sum(axis=0)), [NUM_SUP] * N_WAY)


def test_query_labels_are_binary_over_all_task_cats(episode):
    gt_cls = episode["qry_gt_cls"].numpy()
    valid = gt_cls > 0
    assert valid.any()
    assert set(np.unique(gt_cls[valid])) == {1}
    assert not valid[-NUM_ZERO:].any()


def test_task_cls_aligns_with_proj_anchor_labels(episode):
    task_cls = int(episode["task_cls"])
    assert task_cls == episode["task_cats"][-1] - 1
    proj_cls = episode["proj_cls"].numpy()
    assert (proj_cls == task_cls).any()
    assert len(set(np.unique(proj_cls[proj_cls >= 0]))) >= 2


def test_val_episode_uses_val_cats(ds):
    ep = ds._episode(val_iter=True)
    assert all(c in ds.val_cats for c in ep["task_cats"])


def test_metadata_loader(tmp_path):
    from ood_object_detection_tpu_torch.data.metadata import (
        build_category_pools, load_annotation_index, load_category_counts,
        load_metadata_dicts, split_train_val_cats)
    lvis = tmp_path / "LVIS"
    lvis.mkdir()
    (lvis / "lvis_train_cats.csv").write_text(
        "name,image_count\n"
        "cat_a,50\ncat_b,40\ncat_c,30\ncat_d,20\ncat_e,10\n")
    (lvis / "lvis_annots.txt").write_text(
        "i1;['cat_a'];[[0,0,10,10]]\n"
        "i2;['cat_a','cat_d'];[[0,0,10,10],[5,5,15,15]]\n"
        "i3;['cat_b'];[[1,1,9,9]]\n"
        "i4;['cat_d'];[[2,2,8,8]]\n"
        "i5;['cat_e'];[[3,3,7,7]]\n")
    (lvis / "lvis_sample.txt").write_text(
        "cat_a;['i1','i2']\n"
        "cat_b;['i3']\n"
        "cat_d;['i2','i4']\n"
        "cat_e;['i5']\n")

    counts = load_category_counts(str(lvis / "lvis_train_cats.csv"))
    assert counts == {"cat_a": 50, "cat_b": 40, "cat_c": 30,
                      "cat_d": 20, "cat_e": 10}
    train, val = split_train_val_cats(counts, num_train=2, num_val=2)
    assert set(train) == {"cat_a", "cat_b"}
    assert set(val) == {"cat_c", "cat_d"}
    img_cats, img_bboxes = load_annotation_index(
        str(lvis / "lvis_annots.txt"))
    assert img_cats["i2"] == ["cat_a", "cat_d"]
    assert img_bboxes["i2"] == [[0, 0, 10, 10], [5, 5, 15, 15]]
    pools = build_category_pools(
        str(lvis / "lvis_sample.txt"), img_cats, train, val)
    assert pools["cat_a"] == ["i1"]
    assert sorted(pools["cat_d"]) == ["i2", "i4"]
    assert "cat_e" not in pools
    # the one-call loader equals JAX's
    from ood_object_detection_tpu.data.metadata import (
        load_metadata_dicts as jax_load)
    assert load_metadata_dicts(str(tmp_path), 2, 2) == \
        jax_load(str(tmp_path), 2, 2)


def test_directory_support_source(tmp_path):
    from PIL import Image

    from ood_object_detection_tpu_torch.data.metadata import (
        directory_support_source)
    d = tmp_path / "hot dog"
    d.mkdir()
    Image.new("RGB", (8, 8), (255, 0, 0)).save(d / "a.png")
    Image.new("RGB", (8, 8), (0, 255, 0)).save(d / "b.png")
    src = directory_support_source(str(tmp_path), {7: "hot_dog"})
    assert len(src[7]) == 2
    assert src[7][0]().size == (8, 8)


def test_episode_prefetcher_preserves_order_and_terminates():
    import itertools
    items = [{"i": i} for i in range(7)]
    assert list(EpisodePrefetcher(items, depth=2)) == items
    got = []
    for ep in EpisodePrefetcher(({"i": i} for i in itertools.count()),
                                depth=2):
        got.append(ep["i"])
        if len(got) >= 5:
            break
    assert got == list(range(5))


def test_episode_prefetcher_propagates_producer_errors():
    def bad_source():
        yield {"i": 0}
        raise RuntimeError("decode failed")

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for ep in EpisodePrefetcher(bad_source(), depth=2):
            got.append(ep["i"])
    assert got == [0]


def test_random_trans_supp_aug_toggles():
    model_cfg = get_efficientdet_config(
        "efficientdet_d0", num_classes=1, image_size=(128, 128))

    def make(**kw):
        m = MetaConfig(num_sup=1, num_qry=1, num_zero_images=0,
                       img_size=128, qry_img_size=128, **kw)
        src = SyntheticEpisodeSource(num_cats=3, img_hw=(128, 128))
        return EpisodicDataset(src.support_source([1, 2, 3]), src,
                               model_cfg, m, train_cats=[1, 2],
                               val_cats=[3], val_freq=10 ** 9, device="cpu")

    ds = make()
    assert ds.qry_tf_train is ds.qry_tf_eval
    assert ds.supp_tf_train is ds.supp_tf_eval
    ds_aug = make(random_trans=True, supp_aug=True)
    assert ds_aug.qry_tf_train is not ds_aug.qry_tf_eval
    assert ds_aug.supp_tf_train is not ds_aug.supp_tf_eval
    assert tuple(ds_aug.supp_tf_train.transforms[1].scale) == (0.8, 1.5)
    ep = next(iter(ds_aug))
    assert tuple(ep["qry_images"].shape[1:]) == (128, 128, 3)


def test_query_support_fallback_is_lazy():
    calls = []

    class Src:
        def images_for(self, cat):
            calls.append(cat)
            return [(cat, 0), (cat, 1)]

        def load(self, key):
            return f"img{key}", None

    sup = QuerySupportFallback(Src(), [1, 2, 3])
    assert len(sup) == 3 and 2 in sup and 9 not in sup
    assert calls == [], "loaders must not be built before access"
    pool = sup[2]
    assert calls == [2] and len(pool) == 2
    assert pool[0]() == "img(2, 0)"
    sup[2]
    assert calls == [2], "per-category pools must be cached"
    assert sup.get(9) is None


META = dict(n_way=1, num_sup=2, num_qry=2, num_zero_images=1, img_size=128,
            qry_img_size=128)


def _datasets():
    """(JAX dataset, port dataset) over 4 synthetic categories, 128 px,
    a val episode every 3rd."""
    out = []
    for cfg_fn, meta_cls, mod, kw in (
            (jax_cfg, JaxMeta, jax_episodic, {}),
            (get_efficientdet_config, MetaConfig, port_episodic,
             {"device": "cpu"})):
        src = mod.SyntheticEpisodeSource(num_cats=4, img_hw=(128, 128))
        cats = [1, 2, 3, 4]
        out.append(mod.EpisodicDataset(
            src.support_source(cats), src,
            cfg_fn("efficientdet_d0", num_classes=1, image_size=(128, 128)),
            meta_cls(**META), train_cats=cats[:3], val_cats=cats[3:],
            val_freq=3, num_val_episodes=1, seed=11, **kw))
    return out


def _assert_episode_equal(got, want):
    assert got["task_cats"] == want["task_cats"]
    assert got["val_iter"] == want["val_iter"]
    for key in ("supp_images", "qry_images", "proj_images"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
    for key in ("supp_cls_lab", "qry_cls", "qry_num_positives",
                "qry_gt_bbox", "qry_gt_cls", "proj_cls", "task_cls"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["qry_box"].numpy(),
                               np.asarray(want["qry_box"]), rtol=1e-5,
                               atol=1e-6)


def test_episodes_match_jax():
    """The projection crops draw from Python's global ``random`` (the
    transforms' crop jitter), so each side starts from the same global
    state; the port's episodes come through the prefetcher's thread."""
    jax_ds, port_ds = _datasets()
    random.seed(5)
    want = [ep for _, ep in zip(range(4), jax_ds)]
    random.seed(5)
    got = [ep for _, ep in zip(range(4), EpisodePrefetcher(port_ds))]
    assert [ep["val_iter"] for ep in got] == [False, False, True, False]
    for g, w in zip(got, want):
        _assert_episode_equal(g, w)
    random.seed(6)
    want = jax_ds.known_eval_episode()
    random.seed(6)
    _assert_episode_equal(port_ds.known_eval_episode(), want)
