"""Episode assembly and episode sources for meta-training (port of
``ood_object_detection_tpu.data.episodic``).

An episode is its uint8 images (supports, queries, projection crops)
normalised on the device and its anchor labels: queries at the query
resolution through ``batch_label_anchors`` (K3 -> K4 on the card, their
plain versions on the CPU: the function the JAX builder's vmapped
``label_anchors`` computes), projection crops at the support resolution
with the min-level offset through the per-image ``label_anchors`` with
the task-class merge, as the JAX builder does.

The episode sources are host code copied from the JAX module, and draw
from Python's ``random.Random`` and numpy's ``default_rng`` as it does:
for the same seed they pick the same categories and images and give the
same uint8 arrays and boxes. ``EpisodicDataset`` (with
``known_eval_episode``) streams episodes, ``SyntheticEpisodeSource``
renders category-coloured rectangles, ``QuerySupportFallback`` serves
query images as supports, and ``EpisodePrefetcher`` assembles episodes
on a background thread, whose labelling launches K3 / K4 on the card.
"""
from __future__ import annotations

import random
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.model_config import ModelConfig
from ..factory import resolve_device
from ..meta.config import MetaConfig
from ..ops.anchors import Anchors
from ..ops.target_assigner import batch_label_anchors, label_anchors
from .dataset import pad_annotations
from .device_preproc import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from .transforms import (transforms_coco_eval, transforms_coco_train,
                         transforms_projection)


def _normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> f32 ``(x - mean * 255) / (std * 255)``, the JAX
    builder's f32 operations in its order."""
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=torch.float32) * 255.0
    std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=torch.float32) * 255.0
    return (img_u8.to(torch.float32) - mean.to(img_u8.device)) / \
        std.to(img_u8.device)


class EpisodeBuilder:
    """Assembles episode batches and labels them on ``device`` (the CUDA
    card when None; raises without one). ``kernels=False`` labels the
    queries with the plain versions of K3 / K4 on any device."""

    def __init__(self, model_cfg: ModelConfig, meta_cfg: MetaConfig,
                 device=None, kernels: bool = True):
        self.model_cfg = model_cfg
        self.meta_cfg = meta_cfg
        self.device = resolve_device(device)
        self.kernels = kernels
        self.qry_anchors = Anchors.from_config(
            model_cfg, img_size=meta_cfg.qry_img_size)
        self.proj_anchors = Anchors.from_config(
            model_cfg, img_size=meta_cfg.img_size,
            min_level_offset=meta_cfg.supp_level_offset)
        self._qry_boxes = torch.from_numpy(self.qry_anchors.boxes).to(
            self.device)
        self._proj_boxes = torch.from_numpy(self.proj_anchors.boxes).to(
            self.device)

    @property
    def proj_level_sizes(self) -> List[int]:
        return self.proj_anchors.level_sizes

    def _images(self, imgs) -> torch.Tensor:
        """A [N, H, W, 3] uint8 tensor, or a sequence of [H, W, 3] uint8
        arrays / tensors, normalised on the device."""
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.from_numpy(np.stack([np.asarray(i) for i in imgs]))
        return _normalize(imgs.to(self.device))

    def _gt(self, annos) -> Dict[str, torch.Tensor]:
        padded = [pad_annotations(a) for a in annos]
        return {k: torch.from_numpy(np.stack([a[k] for a in padded])).to(
            self.device) for k in ("bbox", "cls")}

    def build(self, supp_imgs, supp_cls_lab, qry_imgs, qry_annos,
              proj_imgs, proj_annos, task_cls: int, task_cats,
              val_iter: bool) -> Dict:
        """task_cls: the 1-based category id driving the projection targets
        and the >0.9-IoU task merge (the reference uses the LAST task
        category's id here — its loop variable leaks,
        dataloader.py:126,211)."""
        qry = self._gt(qry_annos)
        q_labels = batch_label_anchors(self._qry_boxes, qry["bbox"],
                                       qry["cls"], kernels=self.kernels)
        proj = self._gt(proj_annos)
        # the labeler merge runs in 1-based GT space (labels shift to
        # 0-based afterwards)
        p_cls = torch.stack([
            label_anchors(self._proj_boxes, b, c, task_cls=task_cls
                          ).cls_targets
            for b, c in zip(proj["bbox"], proj["cls"])])
        return {
            "supp_images": self._images(supp_imgs),
            "supp_cls_lab": torch.as_tensor(np.stack(supp_cls_lab)).to(
                self.device),
            "qry_images": self._images(qry_imgs),
            "qry_cls": q_labels.cls_targets,
            "qry_box": q_labels.box_targets,
            "qry_num_positives": q_labels.num_positives,
            "qry_gt_bbox": qry["bbox"],
            "qry_gt_cls": qry["cls"],
            "proj_images": self._images(proj_imgs),
            "proj_cls": p_cls,
            # anchor-label space is 0-based (background -1): the projection
            # losses compare this against proj_cls
            "task_cls": torch.tensor(task_cls - 1, dtype=torch.int32,
                                     device=self.device),
            "task_cats": task_cats,
            "val_iter": val_iter,
        }


class QuerySupportFallback:
    """Lazy {category: [image factories]} view over a query source, for
    runs without a dedicated support pool (driver ``--support-dir`` unset):
    loaders are built per category on FIRST ACCESS and cached, instead of
    eagerly materializing one closure per (category, image) pair up front —
    O(dataset) host work on LVIS-scale data. Matches EpisodicDataset's
    support_source mapping contract (the reference's analog is a web-image
    glob, dataloader.py:274-276)."""

    def __init__(self, query_source, cats: Sequence[int]):
        self._src = query_source
        self._cats = list(cats)
        self._cache: Dict[int, List[Callable]] = {}

    def __getitem__(self, cat: int) -> List[Callable]:
        if cat not in self._cache:
            src = self._src
            self._cache[cat] = [
                (lambda key=key: src.load(key)[0])
                for key in src.images_for(cat)]
        return self._cache[cat]

    def __contains__(self, cat) -> bool:
        return cat in self._cats

    def __iter__(self):
        return iter(self._cats)

    def __len__(self) -> int:
        return len(self._cats)

    def get(self, cat, default=None):
        return self[cat] if cat in self._cats else default


class EpisodicDataset:
    """Infinite episode stream from a support source + annotated queries.

    support_source: {category_id(1-based): [PIL-loadable image factories]}
      (each entry is a zero-arg callable returning a PIL.Image — web images
       in the reference, any source here).
    query_source: object with ``images_for(cat) -> [idx]``,
      ``load(idx) -> (PIL.Image, {'bbox','cls'})`` over all categories.
    device: the ``EpisodeBuilder``'s (the CUDA card when None).
    """

    def __init__(self, support_source: Dict[int, List[Callable]],
                 query_source, model_cfg: ModelConfig, meta_cfg: MetaConfig,
                 train_cats: Sequence[int], val_cats: Sequence[int],
                 val_freq: int = 400, num_val_episodes: int = 50,
                 seed: int = 0, device=None, process_index: int = 0,
                 process_count: int = 1):
        self.support_source = support_source
        self.query_source = query_source
        self.model_cfg = model_cfg
        self.meta_cfg = meta_cfg
        self.train_cats = list(train_cats)
        self.val_cats = list(val_cats)
        for name, ls in (("train", self.train_cats), ("val", self.val_cats)):
            if len(ls) < meta_cfg.n_way:
                raise ValueError(
                    f"n_way={meta_cfg.n_way} needs at least that many "
                    f"{name} categories, got {len(ls)}: {ls}")
        self.val_freq = val_freq
        self.num_val_episodes = num_val_episodes
        # each process of a data-parallel run assembles its own episodes
        # (seed * process_count + process_index, the JAX stream's); the
        # val cadence stays aligned across processes
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        proc_seed = seed * process_count + process_index
        self.rng = random.Random(proc_seed)
        # out-of-stream episodes (known_eval_episode) draw from their
        # own rng: no cross-thread contention with the prefetch producer
        self._eval_rng = random.Random(proc_seed + 0x5EED)
        self.builder = EpisodeBuilder(model_cfg, meta_cfg, device=device)

        mcfg = meta_cfg
        # reference defaults letterbox EVERYTHING; jitter+flip only behind
        # the random_trans / supp_aug toggles (dataloader.py:58-61,114-115)
        self.supp_tf_eval = transforms_coco_eval(
            (mcfg.img_size, mcfg.img_size))
        self.supp_tf_train = transforms_coco_train(
            (mcfg.img_size, mcfg.img_size), scale=(0.8, 1.5)) \
            if mcfg.supp_aug else self.supp_tf_eval
        self.qry_tf_eval = transforms_coco_eval(
            (mcfg.qry_img_size, mcfg.qry_img_size))
        self.qry_tf_train = transforms_coco_train(
            (mcfg.qry_img_size, mcfg.qry_img_size)) \
            if mcfg.random_trans else self.qry_tf_eval
        self.proj_tf = transforms_projection((mcfg.img_size, mcfg.img_size))

    def _episode(self, val_iter: bool,
                 cat_ls: Optional[Sequence[int]] = None,
                 rng: Optional[random.Random] = None) -> Dict:
        """Assemble one n-way episode: supports/queries/projection crops for
        EVERY task category (reference loops all task_cats,
        dataloader.py:109-173), plus num_zero negatives, supports shuffled
        jointly with their one-hot labels (dataloader.py:198-201).

        ``rng`` defaults to the stream rng. Out-of-stream callers
        (known_eval_episode — possibly on a different thread than the
        EpisodePrefetcher producer) pass their own, so the training
        stream stays deterministic under prefetching.
        """
        m = self.meta_cfg
        rng = rng or self.rng
        if cat_ls is None:
            cat_ls = self.val_cats if val_iter else self.train_cats
        cat_ls = list(cat_ls)
        task_cats = rng.sample(cat_ls, m.n_way)

        supp_tf = self.supp_tf_eval if val_iter else self.supp_tf_train
        qry_tf = self.qry_tf_eval if val_iter else self.qry_tf_train
        task_set = np.asarray(task_cats)
        catls_set = np.asarray(cat_ls)

        supp_imgs, supp_lab = [], []
        qry_imgs, qry_annos = [], []
        proj_imgs, proj_annos = [], []
        for cat_ix, cat in enumerate(task_cats):
            pool = self.support_source[cat]
            for factory in [rng.choice(pool) for _ in range(m.num_sup)]:
                img = factory()
                arr, _ = supp_tf(img, dict(bbox=np.zeros((0, 4), np.float32),
                                           cls=np.zeros((0,), np.int32)))
                supp_imgs.append(arr)
                supp_lab.append(np.eye(m.n_way, dtype=np.float32)[cat_ix])

            qry_pool = self.query_source.images_for(cat)
            for idx in [rng.choice(qry_pool) for _ in range(m.num_qry)]:
                img, ann = self.query_source.load(idx)
                # instances of ANY task category count, all as binary
                # class 1 (reference cat_idxs + np.ones labels,
                # dataloader.py:129-167)
                keep = np.isin(ann["cls"], task_set)
                anno = dict(bbox=ann["bbox"][keep].copy(),
                            cls=np.ones(int(keep.sum()), np.int32))
                arr, anno = qry_tf(img, anno)
                qry_imgs.append(arr)
                qry_annos.append(anno)

            # projection crops from this category's queries, labeled with
            # all known categories (reference proj_idxs over cat_ls,
            # dataloader.py:131-135,168-173)
            for idx in [rng.choice(qry_pool) for _ in range(m.num_qry)]:
                img, ann = self.query_source.load(idx)
                keep = np.isin(ann["cls"], catls_set)
                anno = dict(bbox=ann["bbox"][keep].copy(),
                            cls=ann["cls"][keep].copy())
                arr, anno = self.proj_tf(img, anno)
                proj_imgs.append(arr)
                proj_annos.append(anno)

        # negatives: images of other categories, labels empty (reference
        # rejection-samples non-task cats, dataloader.py:175-196 — made
        # total here: when n_way covers the whole split, draw from the
        # other split so small category pools can't spin forever)
        eligible = [c for c in cat_ls if c not in task_cats]
        if not eligible:
            eligible = [c for c in (self.train_cats + self.val_cats)
                        if c not in task_cats]
        for _ in range(m.num_zero_images if eligible else 0):
            other = rng.choice(eligible)
            idx = rng.choice(self.query_source.images_for(other))
            img, _ = self.query_source.load(idx)
            arr, anno = qry_tf(img, dict(bbox=np.zeros((0, 4), np.float32),
                                         cls=np.zeros((0,), np.int32)))
            qry_imgs.append(arr)
            qry_annos.append(anno)

        # joint (image, one-hot) support shuffle
        pairs = list(zip(supp_imgs, supp_lab))
        rng.shuffle(pairs)
        supp_imgs, supp_lab = map(list, zip(*pairs))

        # the projection task class is the LAST task category — the
        # reference's loop variable leaks into the single labeler call
        # (dataloader.py:126,211); kept for parity
        return self.builder.build(
            supp_imgs, supp_lab, qry_imgs, qry_annos, proj_imgs, proj_annos,
            task_cats[-1], task_cats, val_iter)

    def known_eval_episode(self) -> Dict:
        """Eval-transform episode over TRAIN (known) categories — the
        'known' arm of the driver's ``--eval-ood`` AUROC; interleaved val
        episodes over held-out categories are the 'unknown' arm."""
        return self._episode(val_iter=True, cat_ls=self.train_cats,
                             rng=self._eval_rng)

    def __iter__(self) -> Iterator[Dict]:
        i = 0
        while True:
            i += 1
            if self.val_freq and i % self.val_freq == 0:
                for _ in range(self.num_val_episodes):
                    yield self._episode(val_iter=True)
            yield self._episode(val_iter=False)


class SyntheticEpisodeSource:
    """Synthetic per-category image source for tests: each category renders
    rectangles of a category-specific color on noise."""

    def __init__(self, num_cats: int = 6, img_hw: Tuple[int, int] = (128, 128),
                 seed: int = 0):
        self.num_cats = num_cats
        self.img_hw = img_hw
        self.seed = seed
        self._colors = (np.random.default_rng(seed)
                        .integers(40, 255, (num_cats + 1, 3)))

    def _render(self, cat: int, idx: int):
        from PIL import Image
        rng = np.random.default_rng(self.seed + cat * 7919 + idx)
        h, w = self.img_hw
        img = rng.integers(0, 80, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(1, 4))
        boxes, classes = [], []
        for _ in range(n):
            y0 = rng.uniform(0, h * 0.6)
            x0 = rng.uniform(0, w * 0.6)
            bh = rng.uniform(h * 0.2, h * 0.4)
            bw = rng.uniform(w * 0.2, w * 0.4)
            y1, x1 = min(y0 + bh, h - 1), min(x0 + bw, w - 1)
            img[int(y0):int(y1), int(x0):int(x1)] = self._colors[cat]
            boxes.append([y0, x0, y1, x1])
            classes.append(cat)
        ann = dict(bbox=np.asarray(boxes, np.float32),
                   cls=np.asarray(classes, np.int32))
        return Image.fromarray(img), ann

    def support_source(self, cats: Sequence[int], per_cat: int = 10):
        return {
            c: [(lambda c=c, i=i: self._render(c, 1000 + i)[0])
                for i in range(per_cat)]
            for c in cats
        }

    def images_for(self, cat: int):
        return [(cat, i) for i in range(20)]

    def load(self, key):
        cat, i = key
        return self._render(cat, i)


class EpisodePrefetcher:
    """Background-thread episode assembly: the device step never waits
    for host work (PIL loads, crops, padding — the reference hides this
    behind its preloader worker threads, preloader.py:153-278; the
    synchronous iterator serializes host and device time).

    Wraps any episode iterable with a ``depth``-bounded queue. Episode
    ORDER is preserved (one producer thread consumes the underlying
    iterator), so RNG-driven episode streams are reproducible. When the
    consumer stops, the producer thread is joined.
    """

    def __init__(self, episodes, depth: int = 2):
        self.episodes = episodes
        self.depth = depth

    def __iter__(self) -> Iterator[Dict]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        _END = object()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # a producer-side exception is re-raised in the CONSUMER —
            # swallowing it would make a failed episode stream look like
            # a clean end-of-data and silently truncate training
            try:
                for ep in self.episodes:
                    if not _put(ep):
                        return
            except BaseException as e:   # noqa: BLE001 — relayed, not eaten
                _put(e)
                return
            _put(_END)

        t = threading.Thread(target=produce, daemon=True,
                             name="episode-prefetch")
        t.start()
        try:
            while True:
                ep = q.get()
                if ep is _END:
                    return
                if isinstance(ep, BaseException):
                    raise ep
                yield ep
        finally:
            # the producer finishes the episode in hand and ends, so no
            # episode is labelled on the card after the consumer stops
            stop.set()
            t.join()
