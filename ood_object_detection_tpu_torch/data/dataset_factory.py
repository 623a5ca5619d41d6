"""Copy of ``ood_object_detection_tpu.data.dataset_factory``.

Named-dataset factory: dataset name -> parser + directory layout.

Capability match for the reference dataset factory + split configs
(effdet/data/dataset_factory.py:15-99, dataset_config.py:10-178): a user
asks for 'coco2017' / 'voc2007' / 'voc0712' / 'openimages-v5' and gets
`DetectionDataset`s wired to the standard on-disk layout of that dataset,
one per requested split.

Layouts are plain dicts (not dataclass hierarchies): they are static
facts about published datasets, and dicts keep them greppable.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Union

from .dataset import DetectionDataset
from .parsers import CocoParser, OpenImagesParser, Parser, VocParser

# --- split layouts --------------------------------------------------------

_COCO_LAYOUTS = {
    "coco2017": dict(
        train=dict(ann="annotations/instances_train2017.json",
                   img_dir="train2017", has_labels=True),
        val=dict(ann="annotations/instances_val2017.json",
                 img_dir="val2017", has_labels=True),
        test=dict(ann="annotations/image_info_test2017.json",
                  img_dir="test2017", has_labels=False),
        testdev=dict(ann="annotations/image_info_test-dev2017.json",
                     img_dir="test2017", has_labels=False),
    ),
    "coco2014": dict(
        train=dict(ann="annotations/instances_train2014.json",
                   img_dir="train2014", has_labels=True),
        val=dict(ann="annotations/instances_val2014.json",
                 img_dir="val2014", has_labels=True),
    ),
}

def _voc_year_layout(year: str) -> Dict:
    base = f"VOC{year}"
    d = dict(
        train=dict(split=f"{base}/ImageSets/Main/train.txt"),
        val=dict(split=f"{base}/ImageSets/Main/val.txt"),
        trainval=dict(split=f"{base}/ImageSets/Main/trainval.txt"),
    )
    if year == "2007":
        d["test"] = dict(split=f"{base}/ImageSets/Main/test.txt")
    for v in d.values():
        v.update(ann_dir=f"{base}/Annotations", img_dir=f"{base}/JPEGImages")
    return d

_OPENIMAGES_LAYOUTS = {
    "openimages-v5": dict(
        categories="annotations/class-descriptions-boxable.csv",
        splits=dict(
            train=dict(bbox="annotations/train-annotations-bbox.csv",
                       info="annotations/train-info.csv", img_dir="train"),
            val=dict(bbox="annotations/validation-annotations-bbox.csv",
                     info="annotations/validation-info.csv",
                     img_dir="validation"),
        )),
    "openimages-challenge2019": dict(
        categories="annotations/challenge-2019-classes-description-500.csv",
        splits=dict(
            train=dict(
                bbox="annotations/challenge-2019-train-detection-bbox.csv",
                info="annotations/train-info.csv", img_dir="train"),
            val=dict(
                bbox="annotations/challenge-2019-validation-detection-bbox.csv",
                info="annotations/validation-info.csv", img_dir="validation"),
        )),
}


def _merge_parsers(parsers: List[Parser]) -> Parser:
    """Concatenate same-category parsers (the reference VOC 07+12 merge,
    dataset_factory.py:50-64)."""
    base = parsers[0]
    for other in parsers[1:]:
        assert other.cat_names == base.cat_names, "category mismatch in merge"
        offset = len(base.img_ids)
        for j, info in enumerate(other.img_infos):
            info = dict(info, id=offset + j)     # re-key to stay unique
            base.img_ids.append(offset + j)
            base.img_infos.append(info)
        base._anns.extend(other._anns)
    return base


def create_dataset(
        name: str, root: str,
        splits: Union[str, Sequence[str]] = ("train", "val"),
        **parser_kwargs):
    """Build DetectionDataset(s) for a named dataset under ``root``.

    name: coco2017 | coco2014 | voc2007 | voc2012 | voc0712 |
          openimages-v5 | openimages-challenge2019
    Returns one dataset per split (a single dataset if one split asked).
    """
    if isinstance(splits, str):
        splits = (splits,)
    name = name.lower().replace("_", "-")
    datasets = []

    if name.startswith("coco"):
        layout = _COCO_LAYOUTS.get(name)
        if layout is None:
            raise ValueError(f"unknown COCO variant {name}")
        for s in splits:
            if s not in layout:
                raise ValueError(f"split {s!r} not in {name}")
            sc = layout[s]
            parser = CocoParser(os.path.join(root, sc["ann"]), **parser_kwargs)
            datasets.append(DetectionDataset(
                os.path.join(root, sc["img_dir"]), parser))
    elif name.startswith("voc"):
        years = {"voc2007": ["2007"], "voc2012": ["2012"],
                 "voc0712": ["2007", "2012"]}.get(name)
        if years is None:
            raise ValueError(f"unknown VOC variant {name}")
        for s in splits:
            parsers = []
            for year in years:
                layout = _voc_year_layout(year)
                if s not in layout:
                    raise ValueError(f"split {s!r} not in VOC{year}")
                sc = layout[s]
                parsers.append(VocParser(
                    ann_dir=os.path.join(root, sc["ann_dir"]),
                    split_file=os.path.join(root, sc["split"]),
                    **parser_kwargs))
            sizes = [len(p.img_infos) for p in parsers]
            parser = _merge_parsers(parsers)
            # VOC image paths are relative to the year dir; file_name from
            # the XML lacks the dir, so point data_dir at the (single-year)
            # JPEGImages dir; for 0712 the filenames are unique per year
            # dirs, so keep root and patch file_name to include img_dir
            if len(years) == 1:
                data_dir = os.path.join(
                    root, _voc_year_layout(years[0])[s]["img_dir"])
            else:
                data_dir = root
                for i, info in enumerate(parser.img_infos):
                    year = years[0] if i < sizes[0] else years[1]
                    info["file_name"] = os.path.join(
                        f"VOC{year}", "JPEGImages", info["file_name"])
            datasets.append(DetectionDataset(data_dir, parser))
    elif name.startswith("openimages"):
        layout = _OPENIMAGES_LAYOUTS.get(name)
        if layout is None:
            raise ValueError(f"unknown OpenImages variant {name}")
        for s in splits:
            if s not in layout["splits"]:
                raise ValueError(f"split {s!r} not in {name}")
            sc = layout["splits"][s]
            info_path = os.path.join(root, sc["info"])
            parser = OpenImagesParser(
                bbox_csv=os.path.join(root, sc["bbox"]),
                class_csv=os.path.join(root, layout["categories"]),
                image_info_csv=info_path if os.path.exists(info_path) else None,
                **parser_kwargs)
            datasets.append(DetectionDataset(
                os.path.join(root, sc["img_dir"]), parser))
    else:
        raise ValueError(f"unknown dataset {name}")

    return datasets if len(datasets) > 1 else datasets[0]


def eval_flag_kwargs(dataset_name: str) -> Dict:
    """Evaluator-flagged GT kwargs for a named dataset's val split: VOC
    keeps 'difficult' boxes, OpenImages keeps 'IsGroupOf' boxes, so the
    evaluators' ignore/group-of semantics are reachable from real data
    (reference effdet/evaluator.py:45-49). Shared by the pretrain and
    validate CLIs."""
    if dataset_name.startswith("voc"):
        return dict(keep_difficult=True)
    if dataset_name.startswith("openimages"):
        return dict(keep_group_of=True)
    return {}
