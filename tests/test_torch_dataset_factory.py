"""The port's named-dataset factory vs the JAX package's
``create_dataset`` on the same on-disk layouts: the same image directory,
image infos, categories and annotations (equal), the same refusals, and the
same evaluator flags a split keeps."""
import os

import numpy as np
import pytest

from ood_object_detection_tpu.data import dataset_factory as jfactory
from ood_object_detection_tpu_torch.data import dataset_factory as factory

from test_dataset_factory import _write_coco, _write_voc


def _state(ds):
    p = ds.parser
    return (ds.data_dir, p.cat_names, p.img_ids, p.img_infos,
            [{k: v.tolist() for k, v in p.get_ann(i).items()}
             for i in range(len(p))])


def _assert_same(ours, ref):
    ours = ours if isinstance(ours, list) else [ours]
    ref = ref if isinstance(ref, list) else [ref]
    assert [_state(d) for d in ours] == [_state(d) for d in ref]


def test_coco_layouts_match_jax(tmp_path):
    root = str(tmp_path)
    _write_coco(root, "train2017", "annotations/instances_train2017.json")
    _write_coco(root, "val2017", "annotations/instances_val2017.json")
    for splits in ("val", ("train", "val")):
        _assert_same(factory.create_dataset("coco2017", root, splits=splits),
                     jfactory.create_dataset("coco2017", root, splits=splits))
    ds = factory.create_dataset("coco2017", root, splits="val")
    assert ds.data_dir.endswith("val2017") and len(ds) == 1
    np.testing.assert_allclose(ds.parser.get_ann(0)["bbox"][0], [8, 4, 20, 20])


def test_coco2014_layout(tmp_path):
    root = str(tmp_path)
    _write_coco(root, "val2014", "annotations/instances_val2014.json")
    _assert_same(factory.create_dataset("coco2014", root, splits="val"),
                 jfactory.create_dataset("coco2014", root, splits="val"))


@pytest.mark.parametrize("keep_difficult", [False, True])
def test_voc_layouts_match_jax(tmp_path, keep_difficult):
    root = str(tmp_path)
    _write_voc(root, "2007", "trainval", ("a07", "b07"))
    _write_voc(root, "2012", "trainval", ("c12",))
    _write_voc(root, "2007", "test", ("t07",))
    for name, split in (("voc2007", "trainval"), ("voc2012", "trainval"),
                        ("voc0712", "trainval"), ("voc2007", "test")):
        _assert_same(
            factory.create_dataset(name, root, splits=split,
                                   keep_difficult=keep_difficult),
            jfactory.create_dataset(name, root, splits=split,
                                    keep_difficult=keep_difficult))
    merged = factory.create_dataset("voc0712", root, splits="trainval")
    assert len({merged.parser.get_img_info(i)["id"] for i in range(3)}) == 3
    assert merged.parser.get_img_info(2)["file_name"].startswith("VOC2012/")


def test_openimages_layout_matches_jax(tmp_path):
    root = str(tmp_path)
    os.makedirs(os.path.join(root, "annotations"))
    with open(os.path.join(
            root, "annotations/class-descriptions-boxable.csv"), "w") as f:
        f.write("/m/01,Cat\n/m/02,Dog\n")
    with open(os.path.join(
            root, "annotations/validation-annotations-bbox.csv"), "w") as f:
        f.write("ImageID,LabelName,XMin,XMax,YMin,YMax,IsGroupOf\n"
                "img1,/m/01,0.1,0.5,0.2,0.6,0\nimg1,/m/02,0.5,0.9,0.1,0.3,1\n")
    with open(os.path.join(root, "annotations/validation-info.csv"),
              "w") as f:
        f.write("ImageID,Width,Height\nimg1,640,480\n")
    kw = factory.eval_flag_kwargs("openimages-v5")
    assert kw == jfactory.eval_flag_kwargs("openimages-v5")
    _assert_same(factory.create_dataset("openimages-v5", root, splits="val",
                                        **kw),
                 jfactory.create_dataset("openimages-v5", root, splits="val",
                                         **kw))


def test_eval_flags_and_refusals_match_jax(tmp_path):
    for name in ("coco2017", "voc2007", "voc0712", "openimages-v5"):
        assert factory.eval_flag_kwargs(name) == \
            jfactory.eval_flag_kwargs(name)
    root = str(tmp_path)
    _write_coco(root)
    for name, split in (("imagenet", "val"), ("coco2017", "nope"),
                        ("coco2019", "val"), ("voc2010", "val"),
                        ("voc2012", "test"), ("openimages-v9", "val")):
        with pytest.raises(ValueError):
            factory.create_dataset(name, root, splits=split)
        with pytest.raises(ValueError):
            jfactory.create_dataset(name, root, splits=split)
