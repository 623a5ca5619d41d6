"""Copy of ``ood_object_detection_tpu.data.parsers``.

Annotation parsers: COCO JSON, VOC XML, OpenImages CSV.

Pure-Python host-side equivalents of the reference parser package
(effdet/data/parsers/parser_coco.py:11-93, parser_voc.py:14-148,
parser_open_images.py:15-211) without the pycocotools C extension —
annotation indexing is cold-path; numpy is plenty.

A parser exposes: img_ids, img_infos (dict with filename/width/height),
get_ann(idx) -> {'bbox': [N,4] yxyx float32, 'cls': [N] int32 1-based},
and the category id <-> label mapping (cat_dicts capability, parser.py:5-83).
"""
from __future__ import annotations

import csv
import json
import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass
class ParserConfig:
    yxyx: bool = True              # internal box format
    bbox_min_size: float = 1.0     # reference: skip boxes with w<1 or h<1
    ignore_empty_gt: bool = False
    min_img_size: int = 0
    include_masks: bool = False
    has_labels: bool = True
    include_bboxes_ignore: bool = False   # emit crowd/group-of as 'bbox_ignore' 


class Parser:
    """Base parser: category mapping + annotation access."""

    def __init__(self, cfg: Optional[ParserConfig] = None):
        self.cfg = cfg or ParserConfig()
        self.cat_names: List[str] = []
        self.cat_ids: List = []
        self.cat_id_to_label: Dict = {}
        self.img_ids: List = []
        self.img_infos: List[Dict] = []
        self._anns: List[Dict] = []

    @property
    def cat_dicts(self) -> List[Dict]:
        return [
            dict(id=self.cat_id_to_label.get(cid, i + 1), name=name)
            for i, (cid, name) in enumerate(zip(self.cat_ids, self.cat_names))
        ]

    @property
    def max_label(self) -> int:
        return max(self.cat_id_to_label.values()) if self.cat_id_to_label else 0

    def __len__(self):
        return len(self.img_ids)

    def get_img_info(self, idx: int) -> Dict:
        return self.img_infos[idx]

    def get_ann(self, idx: int) -> Dict:
        return self._anns[idx]


class CocoParser(Parser):
    """COCO-format JSON (reference parser_coco.py:11-93), stdlib json."""

    def __init__(self, ann_file: str, cfg: Optional[ParserConfig] = None):
        super().__init__(cfg)
        with open(ann_file) as f:
            data = json.load(f)

        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        self.cat_names = [c["name"] for c in cats]
        self.cat_ids = [c["id"] for c in cats]
        # contiguous 1-based labels
        self.cat_id_to_label = {cid: i + 1 for i, cid in enumerate(self.cat_ids)}

        anns_by_img: Dict = {}
        for a in data.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        for img in data.get("images", []):
            w, h = img.get("width", 0), img.get("height", 0)
            if self.cfg.min_img_size and min(w, h) < self.cfg.min_img_size:
                continue
            img_anns = anns_by_img.get(img["id"], [])
            boxes, classes, ignore_boxes = [], [], []
            for a in img_anns:
                if a.get("ignore", False):
                    continue
                x, y, bw, bh = a["bbox"]
                if bw < self.cfg.bbox_min_size or bh < self.cfg.bbox_min_size:
                    continue
                box = [y, x, y + bh, x + bw]           # xywh -> yxyx
                if a.get("iscrowd", 0):
                    # reference: crowd boxes are excluded from targets and
                    # optionally emitted as ignore regions (parser_coco.py:68)
                    if self.cfg.include_bboxes_ignore:
                        ignore_boxes.append(box)
                    continue
                boxes.append(box)
                classes.append(self.cat_id_to_label[a["category_id"]])
            if self.cfg.ignore_empty_gt and not boxes:
                continue
            self.img_ids.append(img["id"])
            self.img_infos.append(dict(
                id=img["id"], file_name=img["file_name"], width=w, height=h))
            ann = dict(
                bbox=np.asarray(boxes, np.float32).reshape(-1, 4),
                cls=np.asarray(classes, np.int32))
            if self.cfg.include_bboxes_ignore:
                ann["bbox_ignore"] = np.asarray(
                    ignore_boxes, np.float32).reshape(-1, 4)
            self._anns.append(ann)


class VocParser(Parser):
    """Pascal VOC XML annotations (reference parser_voc.py:14-148)."""

    DEFAULT_CLASSES = (
        "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
        "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
        "pottedplant", "sheep", "sofa", "train", "tvmonitor")

    def __init__(self, ann_dir: str, split_file: Optional[str] = None,
                 classes: Optional[Sequence[str]] = None,
                 keep_difficult: bool = False,
                 cfg: Optional[ParserConfig] = None):
        super().__init__(cfg)
        classes = list(classes or self.DEFAULT_CLASSES)
        self.cat_names = classes
        self.cat_ids = classes
        self.cat_id_to_label = {c: i + 1 for i, c in enumerate(classes)}
        self.keep_difficult = keep_difficult

        if split_file:
            with open(split_file) as f:
                stems = [l.strip().split()[0] for l in f if l.strip()]
            xml_files = [os.path.join(ann_dir, s + ".xml") for s in stems]
        else:
            xml_files = sorted(
                os.path.join(ann_dir, f) for f in os.listdir(ann_dir)
                if f.endswith(".xml"))

        for i, xf in enumerate(xml_files):
            root = ET.parse(xf).getroot()
            size = root.find("size")
            w = int(size.findtext("width", "0"))
            h = int(size.findtext("height", "0"))
            fname = root.findtext("filename", os.path.basename(xf)[:-4] + ".jpg")
            boxes, classes_, difficults = [], [], []
            for obj in root.findall("object"):
                difficult = int(obj.findtext("difficult", "0"))
                if difficult and not self.keep_difficult:
                    continue
                name = obj.findtext("name")
                if name not in self.cat_id_to_label:
                    continue
                bb = obj.find("bndbox")
                xmin = float(bb.findtext("xmin"))
                ymin = float(bb.findtext("ymin"))
                xmax = float(bb.findtext("xmax"))
                ymax = float(bb.findtext("ymax"))
                boxes.append([ymin, xmin, ymax, xmax])
                classes_.append(self.cat_id_to_label[name])
                difficults.append(difficult)
            self.img_ids.append(i)
            self.img_infos.append(dict(id=i, file_name=fname, width=w, height=h))
            # per-GT difficult flags ride along so the evaluator can apply
            # VOC semantics (difficult GT excluded from AP; reference
            # per_image_evaluation gt_is_difficult handling)
            self._anns.append(dict(
                bbox=np.asarray(boxes, np.float32).reshape(-1, 4),
                cls=np.asarray(classes_, np.int32),
                difficult=np.asarray(difficults, np.int32)))


class OpenImagesParser(Parser):
    """OpenImages CSV annotations (reference parser_open_images.py:15-211).

    Expects the class-descriptions CSV (id,name) and the bbox CSV with
    columns ImageID,LabelName,XMin,XMax,YMin,YMax (normalized coords).
    Image sizes must be supplied via an image-info CSV (id,width,height) or
    default to the normalized 0..1 space (width=height=1).
    """

    def __init__(self, bbox_csv: str, class_csv: str,
                 image_info_csv: Optional[str] = None,
                 keep_group_of: bool = False,
                 cfg: Optional[ParserConfig] = None):
        """``keep_group_of``: keep IsGroupOf boxes as first-class GT with a
        per-box 'group_of' flag (for the OpenImages evaluator's group-of
        semantics, reference per_image_evaluation.py) instead of dropping
        them / routing to ignore regions."""
        super().__init__(cfg)
        self.keep_group_of = keep_group_of
        with open(class_csv) as f:
            rows = list(csv.reader(f))
        self.cat_ids = [r[0] for r in rows]
        self.cat_names = [r[1] for r in rows]
        self.cat_id_to_label = {c: i + 1 for i, c in enumerate(self.cat_ids)}

        sizes: Dict[str, tuple] = {}
        if image_info_csv:
            with open(image_info_csv) as f:
                for r in csv.DictReader(f):
                    sizes[r["ImageID"]] = (float(r["Width"]), float(r["Height"]))

        by_img: Dict[str, list] = {}
        with open(bbox_csv) as f:
            for r in csv.DictReader(f):
                by_img.setdefault(r["ImageID"], []).append(r)

        for i, (img_id, rows) in enumerate(sorted(by_img.items())):
            w, h = sizes.get(img_id, (1.0, 1.0))
            boxes, classes_, ignore_boxes, group_flags = [], [], [], []
            for r in rows:
                if r["LabelName"] not in self.cat_id_to_label:
                    continue
                box = [float(r["YMin"]) * h, float(r["XMin"]) * w,
                       float(r["YMax"]) * h, float(r["XMax"]) * w]
                is_group = int(r.get("IsGroupOf", "0") or 0)
                if is_group and not self.keep_group_of:
                    # group-of boxes -> ignore regions (reference
                    # parser_open_images.py:175-184: IsGroupOf routed to
                    # gt_bboxes_ignore)
                    if self.cfg.include_bboxes_ignore:
                        ignore_boxes.append(box)
                    continue
                boxes.append(box)
                classes_.append(self.cat_id_to_label[r["LabelName"]])
                group_flags.append(is_group)
            self.img_ids.append(img_id)
            self.img_infos.append(dict(
                id=img_id, file_name=img_id + ".jpg", width=w, height=h))
            ann = dict(
                bbox=np.asarray(boxes, np.float32).reshape(-1, 4),
                cls=np.asarray(classes_, np.int32),
                group_of=np.asarray(group_flags, np.int32))
            if self.cfg.include_bboxes_ignore:
                ann["bbox_ignore"] = np.asarray(
                    ignore_boxes, np.float32).reshape(-1, 4)
            self._anns.append(ann)


def create_parser(name: str, **kwargs) -> Parser:
    """Factory (reference parser_factory.py:10-19)."""
    if name == "coco":
        return CocoParser(**kwargs)
    if name == "voc":
        return VocParser(**kwargs)
    if name == "openimages":
        return OpenImagesParser(**kwargs)
    raise ValueError(f"unknown parser {name}")
