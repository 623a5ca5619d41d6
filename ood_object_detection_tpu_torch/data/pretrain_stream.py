"""Infinite category-balanced pretraining episode stream (port of
``ood_object_detection_tpu.data.pretrain_stream``: host code, copied).

Capability of the reference PretrainDataset (preloader.py:28-150): an
endless iterator that, per step, samples ``num_qry`` categories and one
annotated image per category, interleaves validation blocks every
``val_freq`` steps (``num_val_cats`` held-out categories), applies
train/eval transforms, and emits fixed-shape batches ready for the train
step. load_metadata_dicts' category split by image count
(preloader.py:183-185) becomes ``split_categories_by_count``.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .dataset import collate_batch
from .transforms import transforms_coco_eval, transforms_coco_train


def split_categories_by_count(
        category_counts: Dict[int, int],
        num_train: int,
        num_val: int) -> Tuple[List[int], List[int]]:
    """Rank categories by image count; the most frequent ``num_train`` go to
    train, the next ``num_val`` to validation (preloader.py:183-185)."""
    ranked = sorted(category_counts, key=lambda c: -category_counts[c])
    return ranked[:num_train], ranked[num_train:num_train + num_val]


class PretrainEpisodeStream:
    """query_source protocol: ``images_for(cat) -> [keys]``,
    ``load(key) -> (PIL.Image, {'bbox','cls'})`` (same as EpisodicDataset)."""

    def __init__(self, query_source, image_size: Tuple[int, int],
                 train_cats: Sequence[int], val_cats: Sequence[int],
                 num_qry: int = 8, val_freq: int = 400,
                 num_val_batches: int = 8, max_instances: int = 100,
                 seed: int = 0, random_trans: bool = False,
                 process_index: int = 0, process_count: int = 1):
        self.source = query_source
        self.train_cats = list(train_cats)
        self.val_cats = list(val_cats) or list(train_cats)
        self.num_qry = num_qry
        self.val_freq = val_freq
        self.num_val_batches = num_val_batches
        self.max_instances = max_instances
        # each process of a data-parallel run draws its own stream
        # (seed * process_count + process_index, the JAX stream's); the
        # val cadence (i % val_freq) stays aligned across processes
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        self.rng = random.Random(seed * process_count + process_index)
        # reference default: train items are letterboxed too; jitter+flip
        # only behind random_trans (preloader.py:71-76)
        self.eval_tf = transforms_coco_eval(image_size)
        self.train_tf = transforms_coco_train(image_size) \
            if random_trans else self.eval_tf

    def _batch(self, val_iter: bool) -> Dict[str, np.ndarray]:
        cats = self.val_cats if val_iter else self.train_cats
        tf = self.eval_tf if val_iter else self.train_tf
        picked = [self.rng.choice(cats) for _ in range(self.num_qry)]
        samples = []
        for cat in picked:
            pool = self.source.images_for(cat)
            if not pool:
                continue
            img, ann = self.source.load(self.rng.choice(pool))
            anno = dict(bbox=ann["bbox"].copy(), cls=ann["cls"].copy())
            arr, anno = tf(img, anno)
            samples.append((arr, anno))
        batch = collate_batch(samples, self.max_instances)
        batch["val_iter"] = val_iter
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        i = 0
        while True:
            i += 1
            if self.val_freq and i % self.val_freq == 0:
                for _ in range(self.num_val_batches):
                    yield self._batch(val_iter=True)
            yield self._batch(val_iter=False)


class ParserQuerySource:
    """Adapts a data.parsers.Parser + image dir to the query_source
    protocol used by the episodic/pretrain streams."""

    def __init__(self, data_dir: str, parser):
        self.data_dir = data_dir
        self.parser = parser
        self._by_cat: Dict[int, List[int]] = {}
        for idx in range(len(parser)):
            for c in np.unique(parser.get_ann(idx)["cls"]):
                self._by_cat.setdefault(int(c), []).append(idx)

    def category_counts(self) -> Dict[int, int]:
        return {c: len(v) for c, v in self._by_cat.items()}

    def images_for(self, cat: int) -> List[int]:
        return self._by_cat.get(int(cat), [])

    def load(self, idx: int):
        import os

        from PIL import Image
        info = self.parser.get_img_info(idx)
        ann = self.parser.get_ann(idx)
        img = Image.open(os.path.join(
            self.data_dir, info["file_name"])).convert("RGB")
        return img, ann
