"""``data.episodic.EpisodeBuilder`` against the JAX package's, on the same
uint8 images and annotations: the normalised images bit for bit, the
query labels (``batch_label_anchors``: the plain versions of K3 -> K4 on
the CPU) and the projection labels (per-image ``label_anchors`` with the
task-class merge) against the JAX builder's vmapped ``label_anchors``.

Two sizes: the tiny set-up (128 px everywhere) and the meta defaults'
resolutions (640 px queries: 76,725 anchors; 256 px projection crops with
the min-level offset 2: 756 anchors), a few images each. Each has a query
with no ground truth (the zero image), a projection crop with a box of
another class that overlaps a task-class box above 0.9 IoU (merged into
the task class), and identical boxes.

Class targets, match-derived positives, the GT and the task class are
equal; box targets equal to rtol 1e-5 / atol 1e-6 (the encoding's log).
``EpisodeBuilder`` builds on the card unless asked for the CPU.
"""
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data.episodic import (
    EpisodeBuilder as JaxBuilder)
from ood_object_detection_tpu.meta.config import MetaConfig as JaxMeta
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.data.episodic import EpisodeBuilder
from ood_object_detection_tpu_torch.meta import MetaConfig

SIZES = {"tiny": dict(img_size=128, qry_img_size=128),
         "meta_defaults": dict(img_size=256, qry_img_size=640)}
TASK = 3


def _boxes(rng, n, size):
    yx = rng.uniform(0, size * 0.7, (n, 2))
    hw = rng.uniform(size * 0.05, size * 0.3, (n, 2))
    return np.concatenate([yx, np.minimum(yx + hw, size - 1)],
                          1).astype(np.float32)


def _inputs(meta, seed=0):
    rng = np.random.default_rng(seed)
    s, q = meta["img_size"], meta["qry_img_size"]
    supp = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
            for _ in range(2)]
    qry = [rng.integers(0, 256, (q, q, 3), dtype=np.uint8)
           for _ in range(3)]
    qry_annos = [dict(bbox=_boxes(rng, 4, q), cls=np.ones(4, np.int32)),
                 dict(bbox=_boxes(rng, 1, q), cls=np.ones(1, np.int32)),
                 dict(bbox=np.zeros((0, 4), np.float32),
                      cls=np.zeros(0, np.int32))]
    qry_annos[0]["bbox"][1] = qry_annos[0]["bbox"][0]     # identical boxes
    proj = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
            for _ in range(2)]
    p0 = _boxes(rng, 3, s)
    p0[2] = p0[0] + np.float32(0.5)          # > 0.9 IoU with the task box
    proj_annos = [dict(bbox=p0, cls=np.array([TASK, 1, 5], np.int32)),
                  dict(bbox=_boxes(rng, 2, s),
                       cls=np.array([2, TASK], np.int32))]
    supp_lab = [np.array([1.0], np.float32)] * 2
    return (supp, supp_lab, qry, qry_annos, proj, proj_annos, TASK, [TASK],
            False)


@pytest.mark.parametrize("size", list(SIZES))
def test_episode_builder_matches_jax(size):
    kw = dict(num_sup=2, num_qry=2, num_zero_images=1, **SIZES[size])
    jbuild = JaxBuilder(jax_cfg("efficientdet_d0", num_classes=1),
                        JaxMeta(**kw))
    build = EpisodeBuilder(get_efficientdet_config("efficientdet_d0",
                                                   num_classes=1),
                           MetaConfig(**kw), device="cpu")
    assert build.proj_level_sizes == jbuild.proj_level_sizes
    args = _inputs(SIZES[size])
    want = jbuild.build(*args)
    got = build.build(*args)
    assert set(got) == set(want)
    assert got["task_cats"] == want["task_cats"] and not got["val_iter"]
    exact = ("supp_images", "supp_cls_lab", "qry_images", "proj_images",
             "qry_cls", "qry_num_positives", "qry_gt_bbox", "qry_gt_cls",
             "proj_cls", "task_cls")
    for key in exact:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["qry_box"].numpy(),
                               np.asarray(want["qry_box"]), rtol=1e-5,
                               atol=1e-6)
    n_anchors = {"tiny": 3069, "meta_defaults": 76725}[size]
    assert got["qry_cls"].shape == (3, n_anchors)
    assert float(got["qry_num_positives"][2]) == 0.0        # the zero image
    assert (got["proj_cls"] == TASK - 1).any()
    assert int(got["task_cls"]) == TASK - 1


def test_episode_builder_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EpisodeBuilder(get_efficientdet_config("efficientdet_d0",
                                               num_classes=1), MetaConfig())
