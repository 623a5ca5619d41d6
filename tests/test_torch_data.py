"""The port's host data pipeline vs the JAX package's on the same inputs.

Parsers give equal annotations; the PIL transforms give bit-equal uint8
canvases, boxes and ``img_scale`` (the train ones from the same ``random``
seed); the synthetic and file datasets, ``pad_annotations`` and
``collate_batch`` are equal; ``PrefetchLoader(device="cpu")`` yields the
JAX loader's batches in its order, the partial last batch included, with
its normalised images within 1e-6 (``normalize_uint8`` to 1e-6 as well);
``resolve_input_config`` is equal. The port decodes with PIL, the JAX
package with its native libjpeg core where that loads: both give the same
pixels here.
"""
import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import ood_object_detection_tpu.data as jdata
from ood_object_detection_tpu.data import parsers as jparsers
from ood_object_detection_tpu_torch.data import dataset, device_preproc, parsers
from ood_object_detection_tpu_torch.data import transforms
from ood_object_detection_tpu_torch.data.input_config import (
    resolve_input_config)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _parser_state(p):
    return dict(cat_names=p.cat_names, cat_ids=p.cat_ids,
                labels=sorted(p.cat_id_to_label.items()),
                img_ids=p.img_ids, infos=p.img_infos,
                anns=[p.get_ann(i) for i in range(len(p))],
                cat_dicts=p.cat_dicts, max_label=p.max_label)


def _coco_json(tmp_path):
    data = {
        "categories": [{"id": 7, "name": "dog"}, {"id": 3, "name": "cat"}],
        "images": [{"id": 1, "file_name": "a.jpg", "width": 100,
                    "height": 80},
                   {"id": 2, "file_name": "b.jpg", "width": 50, "height": 40},
                   {"id": 3, "file_name": "c.jpg", "width": 20, "height": 20}],
        "annotations": [
            {"image_id": 1, "category_id": 7, "bbox": [10, 20, 30, 40]},
            {"image_id": 1, "category_id": 3, "bbox": [0, 0, 5, 5]},
            {"image_id": 1, "category_id": 3, "bbox": [20, 20, 10, 10],
             "iscrowd": 1},
            {"image_id": 1, "category_id": 3, "bbox": [40, 40, 0.5, 10]},
            {"image_id": 2, "category_id": 7, "bbox": [6, 6, 10, 10],
             "ignore": True},
            {"image_id": 2, "category_id": 7, "bbox": [1, 2, 30, 20]}],
    }
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(data))
    return str(path)


@pytest.mark.parametrize("cfg", [
    {}, dict(include_bboxes_ignore=True), dict(ignore_empty_gt=True),
    dict(min_img_size=30), dict(bbox_min_size=0.0)])
def test_coco_parser_matches_jax(tmp_path, cfg):
    path = _coco_json(tmp_path)
    _assert_tree_equal(
        _parser_state(parsers.CocoParser(path, parsers.ParserConfig(**cfg))),
        _parser_state(jparsers.CocoParser(path, jparsers.ParserConfig(**cfg))))


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_parser_matches_jax(tmp_path, keep_difficult):
    for stem, objs in (("x", [("dog", 0, (10, 20, 50, 60)),
                              ("cat", 1, (1, 1, 2, 2)),
                              ("zebra", 0, (3, 3, 9, 9))]),
                       ("y", [("cat", 0, (5, 6, 70, 80))])):
        body = "".join(
            f"<object><name>{n}</name><difficult>{d}</difficult><bndbox>"
            f"<xmin>{b[0]}</xmin><ymin>{b[1]}</ymin><xmax>{b[2]}</xmax>"
            f"<ymax>{b[3]}</ymax></bndbox></object>" for n, d, b in objs)
        (tmp_path / f"{stem}.xml").write_text(
            f"<annotation><filename>{stem}.jpg</filename><size><width>200"
            f"</width><height>100</height></size>{body}</annotation>")
    (tmp_path / "split.txt").write_text("y\nx\n")
    for split in (None, str(tmp_path / "split.txt")):
        _assert_tree_equal(
            _parser_state(parsers.VocParser(str(tmp_path), split,
                                            keep_difficult=keep_difficult)),
            _parser_state(jparsers.VocParser(str(tmp_path), split,
                                             keep_difficult=keep_difficult)))


@pytest.mark.parametrize("keep_group_of", [False, True])
def test_openimages_parser_matches_jax(tmp_path, keep_group_of):
    (tmp_path / "cls.csv").write_text("/m/01,Cat\n/m/02,Dog\n")
    (tmp_path / "bbox.csv").write_text(
        "ImageID,LabelName,XMin,XMax,YMin,YMax,IsGroupOf\n"
        "img2,/m/02,0.2,0.4,0.1,0.3,0\n"
        "img1,/m/01,0.1,0.5,0.2,0.6,0\n"
        "img1,/m/01,0.6,0.9,0.6,0.9,1\n"
        "img1,/m/09,0.1,0.2,0.1,0.2,0\n")
    (tmp_path / "info.csv").write_text("ImageID,Width,Height\nimg1,640,480\n")
    kw = dict(keep_group_of=keep_group_of, image_info_csv=str(
        tmp_path / "info.csv"))
    args = (str(tmp_path / "bbox.csv"), str(tmp_path / "cls.csv"))
    _assert_tree_equal(
        _parser_state(parsers.OpenImagesParser(
            *args, cfg=parsers.ParserConfig(include_bboxes_ignore=True),
            **kw)),
        _parser_state(jparsers.OpenImagesParser(
            *args, cfg=jparsers.ParserConfig(include_bboxes_ignore=True),
            **kw)))
    with pytest.raises(ValueError):
        parsers.create_parser("lvis")


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _anno(h, w, seed, n=5):
    rng = np.random.default_rng(seed)
    yx = rng.uniform(0, 1, (n, 2)) * [h, w]
    box = np.concatenate([yx, yx + rng.uniform(0.5, 0.6, (n, 2)) * [h, w]],
                         1).astype(np.float32)
    return dict(bbox=box, cls=np.arange(1, n + 1, dtype=np.int32),
                difficult=np.array([0, 1, 0, 0, 1], np.int32))


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
@pytest.mark.parametrize("hw,target", [((300, 400), (512, 512)),
                                       ((200, 160), (96, 128)),
                                       ((100, 80), (640, 640)),
                                       ((480, 640), (128, 128))])
def test_resize_pad_matches_jax(hw, target, interpolation):
    """The eval letterbox: bit-equal canvas, boxes, flags and img_scale."""
    got = transforms.transforms_coco_eval(
        target, interpolation=interpolation)(_image(*hw, 0), _anno(*hw, 1))
    want = jdata.transforms_coco_eval(
        target, interpolation=interpolation)(_image(*hw, 0), _anno(*hw, 1))
    assert got[0].shape == tuple(target) + (3,)
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("pipeline", ["transforms_coco_train",
                                      "transforms_projection"])
def test_train_transforms_match_jax(pipeline):
    """Flip, jittered resize and projection crops from the same
    ``random`` seed: bit-equal outputs."""
    for seed in range(4):
        out = []
        for mod in (transforms, jdata):
            random.seed(seed)
            out.append(getattr(mod, pipeline)((128, 96))(
                _image(90, 120, seed), _anno(90, 120, seed + 10)))
        _assert_tree_equal(*out)


def test_synthetic_dataset_pad_and_collate_match_jax():
    ours = dataset.SyntheticDetectionDataset(num_images=5, image_size=(64, 48),
                                             num_classes=7, seed=3)
    ref = jdata.SyntheticDetectionDataset(num_images=5, image_size=(64, 48),
                                          num_classes=7, seed=3)
    samples = [ours[i] for i in range(5)]
    _assert_tree_equal(samples, [ref[i] for i in range(5)])
    _assert_tree_equal(dataset.pad_annotations(samples[0][1], 10),
                       jdata.pad_annotations(samples[0][1], 10))
    _assert_tree_equal(dataset.collate_batch(samples, 20),
                       jdata.collate_batch(samples, 20))
    # string ids (OpenImages) map to the same numeric key
    s = [(samples[0][0], dict(samples[0][1], img_id="0a1b"))]
    _assert_tree_equal(dataset.collate_batch(s), jdata.collate_batch(s))


def _coco_split(tmp_path, sizes=((48, 64), (30, 40), (64, 48), (50, 50),
                                 (40, 30))):
    """A COCO json and JPEGs of the given (h, w) sizes."""
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        _image(h, w, i).save(tmp_path / f"{i}.jpg", quality=90)
        images.append(dict(id=i + 10, file_name=f"{i}.jpg", height=h,
                           width=w))
        anns.append(dict(image_id=i + 10, category_id=1 + i % 2,
                         bbox=[2.0 + i, 3.0, w / 2, h / 3]))
    path = tmp_path / "ann.json"
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=[dict(id=1, name="a"),
                                                dict(id=2, name="b")])))
    return str(path)


def test_detection_dataset_matches_jax(tmp_path):
    path = _coco_split(tmp_path)
    tf = dict(img_size=(64, 64), fill_color=(124, 116, 104))
    ours = dataset.DetectionDataset(str(tmp_path), parsers.CocoParser(path),
                                    transforms.transforms_coco_eval(**tf))
    ref = jdata.DetectionDataset(str(tmp_path), jparsers.CocoParser(path),
                                 jdata.transforms_coco_eval(**tf))
    assert len(ours) == len(ref) == 5
    _assert_tree_equal([ours[i] for i in range(5)],
                       [ref[i] for i in range(5)])
    sub = dataset.SkipSubset(ours, 2)
    assert len(sub) == 3 and sub.parser is ours.parser
    _assert_tree_equal(sub[1], ref[2])


def _batches_match(ours, ref):
    assert len(ours) == len(ref)
    for got, want in zip(ours, ref):
        assert set(got) == set(want)
        for k, v in want.items():
            v = np.asarray(v)
            if k == "image":
                assert got[k].dtype == torch.float32
                np.testing.assert_allclose(got[k].numpy(), v, rtol=0,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(got[k].numpy(), v)
                # img_id stays int64, as collated; jax without x64 keeps
                # it as int32 on the device
                assert got[k].numpy().dtype == (
                    np.int64 if k == "img_id" else v.dtype)


@pytest.mark.parametrize("shuffle", [False, True])
def test_prefetch_loader_matches_jax(tmp_path, shuffle):
    """Five letterboxed JPEGs at batch 2: batches of 2, 2 and 1 in the JAX
    loader's order, normalised with non-default mean / std."""
    path = _coco_split(tmp_path)
    kw = dict(batch_size=2, shuffle=shuffle, workers=2, drop_last=False,
              seed=5, mean=(0.5, 0.4, 0.3), std=(0.2, 0.25, 0.3))
    ours = dataset.PrefetchLoader(dataset.DetectionDataset(
        str(tmp_path), parsers.CocoParser(path),
        transforms.transforms_coco_eval((64, 64))), device="cpu", **kw)
    ref = jdata.PrefetchLoader(jdata.DetectionDataset(
        str(tmp_path), jparsers.CocoParser(path),
        jdata.transforms_coco_eval((64, 64))), **kw)
    assert len(ours) == len(ref) == 3
    for epoch in range(2):            # a fresh shuffle each epoch
        got, want = list(ours), list(ref)
        assert [len(b["img_id"]) for b in got] == [2, 2, 1]
        _batches_match(got, want)


def test_prefetch_loader_drop_last_matches_jax():
    ds = dataset.SyntheticDetectionDataset(num_images=10, image_size=(32, 32))
    jds = jdata.SyntheticDetectionDataset(num_images=10, image_size=(32, 32))
    for kw in (dict(batch_size=4, shuffle=True),
               dict(batch_size=3, drop_last=False),
               dict(batch_size=4, shuffle=True, drop_last=False, seed=7)):
        ours = list(dataset.PrefetchLoader(ds, workers=1, device="cpu", **kw))
        _batches_match(ours, list(jdata.PrefetchLoader(jds, workers=1, **kw)))


def test_loader_refusals():
    ds = dataset.SyntheticDetectionDataset(num_images=2)
    with pytest.raises(NotImplementedError, match="RandomErasing"):
        dataset.PrefetchLoader(ds, 2, device="cpu", re_prob=0.5)
    with pytest.raises(NotImplementedError, match="item 7"):
        dataset.create_loader(ds, (64, 64), 2, distributed=True,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="RandomErasing"):
        dataset.create_loader(ds, (64, 64), 2, is_training=True, re_prob=0.3,
                              device="cpu")


def test_create_loader_transforms_match_jax(tmp_path):
    path = _coco_split(tmp_path)
    ours = dataset.create_loader(
        dataset.DetectionDataset(str(tmp_path), parsers.CocoParser(path)),
        (48, 48), 3, workers=1, device="cpu")
    ref = jdata.create_loader(
        jdata.DetectionDataset(str(tmp_path), jparsers.CocoParser(path)),
        (48, 48), 3, workers=1)
    _batches_match(list(ours), list(ref))


def test_normalize_uint8_matches_jax():
    images = np.random.default_rng(0).integers(0, 256, (2, 9, 7, 3),
                                               dtype=np.uint8)
    for kw in ({}, dict(mean=(0.5, 0.5, 0.5), std=(0.2, 0.3, 0.4))):
        got = device_preproc.normalize_uint8(torch.from_numpy(images), **kw)
        want = jdata.normalize_uint8(jnp.asarray(images), **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("args", [
    {}, dict(image_size=320, interpolation="bilinear"),
    dict(mean=[0.5], std=[0.25, 0.25, 0.25], fill_color="128"),
    dict(fill_color=7), dict(fill_color="mean", mean=(0.1, 0.2, 0.3))])
def test_resolve_input_config_matches_jax(args):
    from ood_object_detection_tpu.config import get_efficientdet_config
    cfg = get_efficientdet_config("efficientdet_d1")
    assert resolve_input_config(dict(args), cfg) == \
        jdata.resolve_input_config(dict(args), cfg)
