"""Episodic metadata loading: category splits + per-category image pools
(port of ``ood_object_detection_tpu.data.metadata``: host code, copied).

Equivalent of the reference load_metadata_dicts (preloader.py:153-278 and
dataloader.py:217-284): parse a category-count CSV, rank categories by
image count and split train/val, parse a flat annotation index
(path;cats;bboxes per line), build per-category image pools with
train/val image de-overlap, and glob per-category support-image
directories. Stdlib-only host code (cold path).
"""
from __future__ import annotations

import ast
import csv
import glob
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def load_category_counts(csv_path: str,
                         exclude: Sequence[str] = ()) -> Dict[str, int]:
    """Read a CSV with 'name' and 'image_count' columns
    (reference lvis_train_cats.csv parse, preloader.py:166-172)."""
    counts: Dict[str, int] = {}
    with open(csv_path) as fp:
        for row in csv.DictReader(fp):
            if row["name"] in exclude:
                continue
            counts[row["name"]] = int(row["image_count"])
    return counts


def split_train_val_cats(counts: Dict[str, int], num_train: int,
                         num_val: int) -> Tuple[List[str], List[str]]:
    """Most-frequent ``num_train`` categories train; the next ``num_val``
    below them validate (reference rank-by-image_count split,
    preloader.py:183-185). One implementation shared with the pretrain
    stream (pretrain_stream.split_categories_by_count)."""
    from .pretrain_stream import split_categories_by_count
    return split_categories_by_count(counts, num_train, num_val)


def load_annotation_index(txt_path: str,
                          path_map: Optional[Callable[[str], str]] = None,
                          ) -> Tuple[Dict[str, list], Dict[str, list]]:
    """Parse 'img_path;[cats];[bboxes]' lines into {path: cats} and
    {path: bboxes} dicts (reference lvis_annots.txt parse,
    preloader.py:187-195)."""
    path_map = path_map or (lambda p: p)
    cats: Dict[str, list] = {}
    bboxes: Dict[str, list] = {}
    with open(txt_path) as fp:
        for line in fp:
            parts = line.rstrip("\n").split(";")
            if len(parts) < 3:
                continue
            key = path_map(parts[0])
            cats[key] = ast.literal_eval(parts[1])
            bboxes[key] = ast.literal_eval(parts[2])
    return cats, bboxes


def build_category_pools(sample_txt: str,
                         img_cats: Dict[str, list],
                         train_cats: Sequence[str],
                         val_cats: Sequence[str],
                         path_map: Optional[Callable[[str], str]] = None,
                         ) -> Dict[str, List[str]]:
    """Per-category image pools from 'cat;[img_paths]' lines, dropping any
    *train*-category image that also contains a val category (the
    reference's train/val image de-overlap, preloader.py:222-237)."""
    path_map = path_map or (lambda p: p)
    train_set, val_set = set(train_cats), set(val_cats)
    pools: Dict[str, List[str]] = {}
    with open(sample_txt) as fp:
        for line in fp:
            parts = line.rstrip("\n").split(";")
            if len(parts) < 2:
                continue
            cat = parts[0]
            if cat not in train_set and cat not in val_set:
                continue
            imgs = []
            # sorted: set iteration order varies with PYTHONHASHSEED,
            # which would make seeded episode sampling non-reproducible
            for img in sorted(set(ast.literal_eval(parts[1]))):
                img = path_map(img)
                if cat in train_set:
                    if any(c in val_set for c in img_cats.get(img, ())):
                        continue
                imgs.append(img)
            pools[cat] = imgs
    return pools


def directory_support_source(root: str, cat_names: Dict[int, str],
                             ) -> Dict[int, List[Callable]]:
    """Per-category support pools from a directory tree:
    ``root/<category name with spaces>/*`` (reference web-image glob,
    dataloader.py:274-276). Returns {cat_id: [zero-arg loaders]} matching
    EpisodicDataset's support_source contract."""
    from PIL import Image

    out: Dict[int, List[Callable]] = {}
    for cat_id, name in cat_names.items():
        paths = sorted(glob.glob(
            os.path.join(root, name.replace("_", " "), "*")))
        if not paths:   # also accept the raw (underscored) name
            paths = sorted(glob.glob(os.path.join(root, name, "*")))
        out[int(cat_id)] = [
            (lambda p=p: Image.open(p).convert("RGB")) for p in paths]
    return out


def load_metadata_dicts(base_path: str,
                        num_train_cats: int,
                        num_val_cats: int,
                        cats_csv: str = "LVIS/lvis_train_cats.csv",
                        annots_txt: str = "LVIS/lvis_annots.txt",
                        sample_txt: str = "LVIS/lvis_sample.txt",
                        web_dir: str = "web_images",
                        exclude: Sequence[str] = ()):
    """One-call equivalent of the reference load_metadata_dicts
    (preloader.py:153-278): returns (sample_pools, web_support_pools,
    img_bboxes, img_cats, train_cats, val_cats) keyed by category name."""
    counts = load_category_counts(
        os.path.join(base_path, cats_csv), exclude=exclude)
    train_cats, val_cats = split_train_val_cats(
        counts, num_train_cats, num_val_cats)
    img_cats, img_bboxes = load_annotation_index(
        os.path.join(base_path, annots_txt))
    pools = build_category_pools(
        os.path.join(base_path, sample_txt), img_cats, train_cats, val_cats)
    web = {
        cat: sorted(glob.glob(os.path.join(
            base_path, web_dir, cat.replace("_", " "), "*")))
        for cat in pools
    }
    return pools, web, img_bboxes, img_cats, train_cats, val_cats
