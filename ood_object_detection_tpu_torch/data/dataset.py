"""Datasets and the batching loader, feeding the card.

Port of ``ood_object_detection_tpu.data.dataset``. The datasets, the
padding and the collation are host numpy, copied; JPEGs are decoded by the
native libjpeg core (``data/native_decode.py``) where it loads and by PIL
where it does not, as in the JAX package. ``PrefetchLoader`` collates on
host threads, then copies each batch to its ``device`` (the CUDA card
unless the caller names another) from pinned memory with
``non_blocking=True`` and normalises the uint8 images there
(``normalize_uint8``), a few batches ahead of the consumer.
"""
from __future__ import annotations

import os
import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..factory import resolve_device
from . import native_decode
from .device_preproc import normalize_uint8
from .parsers import Parser
from .random_erasing import random_erasing
from .transforms import transforms_coco_eval, transforms_coco_train

MAX_INSTANCES = 100


class DetectionDataset:
    """Image + annotation dataset (reference DetectionDatset,
    dataset.py:12-65). A JPEG is decoded by the GIL-free native core when
    ``native_decode.available()``, then wrapped as a PIL image so the
    transforms are unchanged; other files, and JPEGs where the core does
    not load or fails, are decoded by PIL (the JAX package's order)."""

    def __init__(self, data_dir: str, parser: Parser,
                 transform: Optional[Callable] = None):
        self.data_dir = data_dir
        self.parser = parser
        self.transform = transform

    def __len__(self):
        return len(self.parser)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict]:
        from PIL import Image
        info = self.parser.get_img_info(idx)
        ann = self.parser.get_ann(idx)
        anno = dict(
            bbox=ann["bbox"].copy(), cls=ann["cls"].copy(),
            img_id=info["id"],
            img_size=(info["width"], info["height"]))
        # evaluator flags (VOC difficult / OpenImages group-of) ride along
        # so the evaluators see them (reference evaluator.py:45-49)
        for k in ("difficult", "group_of"):
            if k in ann:
                anno[k] = ann[k].copy()
        path = os.path.join(self.data_dir, info["file_name"])
        img = None
        if path.lower().endswith((".jpg", ".jpeg")):
            if native_decode.available():
                with open(path, "rb") as f:
                    arr = native_decode.decode_jpeg(f.read())
                if arr is not None:
                    img = Image.fromarray(arr)
        if img is None:
            img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img, anno = self.transform(img, anno)
        return img, anno


class SkipSubset:
    """Every-nth-sample view (reference SkipSubset, dataset.py:68-97)."""

    def __init__(self, dataset, n: int = 2):
        self.dataset = dataset
        self.n = max(n, 1)
        self.indices = list(range(0, len(dataset), self.n))

    @property
    def parser(self):
        return self.dataset.parser

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class SyntheticDetectionDataset:
    """Fixed-seed synthetic dataset: class-colored rectangles rendered on
    noise backgrounds — a *learnable* stand-in for LVIS/COCO paths: each
    class has a distinctive color, so a detector trained on it must produce
    real detections."""

    def __init__(self, num_images: int = 64,
                 image_size: Tuple[int, int] = (512, 512),
                 num_classes: int = 10, max_boxes: int = 8, seed: int = 0,
                 color_seed: int = 1234):
        self.num_images = num_images
        self.image_size = image_size
        self.num_classes = num_classes
        self.max_boxes = max_boxes
        self.seed = seed
        # class colors are shared across seeds so train/val agree
        self.colors = np.random.default_rng(color_seed).integers(
            60, 255, (num_classes + 1, 3))

    def __len__(self):
        return self.num_images

    def __getitem__(self, idx: int):
        rng = np.random.default_rng(self.seed * 100003 + idx)
        h, w = self.image_size
        img = rng.integers(0, 50, (h, w, 3)).astype(np.uint8)
        n = int(rng.integers(1, self.max_boxes + 1))
        ymin = rng.uniform(0, h * 0.8, n)
        xmin = rng.uniform(0, w * 0.8, n)
        bh = rng.uniform(h * 0.08, h * 0.3, n)
        bw = rng.uniform(w * 0.08, w * 0.3, n)
        bbox = np.stack(
            [ymin, xmin, np.minimum(ymin + bh, h - 1),
             np.minimum(xmin + bw, w - 1)],
            axis=1).astype(np.float32)
        cls = rng.integers(1, self.num_classes + 1, n).astype(np.int32)
        for (y0, x0, y1, x1), c in zip(bbox, cls):
            img[int(y0):int(y1), int(x0):int(x1)] = self.colors[c]
        anno = dict(bbox=bbox, cls=cls, img_id=idx, img_size=(w, h),
                    img_scale=1.0)
        return img, anno


def pad_annotations(anno: Dict, max_instances: int = MAX_INSTANCES) -> Dict:
    """Pad bbox/cls to fixed size with -1 fill (loader.py:31-33 semantics)."""
    n = min(len(anno["cls"]), max_instances)
    bbox = np.full((max_instances, 4), -1.0, np.float32)
    cls = np.full((max_instances,), -1, np.int32)
    bbox[:n] = anno["bbox"][:n]
    cls[:n] = anno["cls"][:n]
    out = dict(anno)
    out["bbox"] = bbox
    out["cls"] = cls
    for k in ("difficult", "group_of"):
        if k in anno:
            flags = np.zeros((max_instances,), np.int32)
            flags[:n] = anno[k][:n]
            out[k] = flags
    return out


def _numeric_id(img_id) -> int:
    """Image ids must be integers on the device; string ids (OpenImages)
    map to a stable CRC32 key (uniqueness is what the evaluators need)."""
    if isinstance(img_id, (int, np.integer)):
        return int(img_id)
    return zlib.crc32(str(img_id).encode()) & 0x7FFFFFFF


def collate_batch(samples: List[Tuple[np.ndarray, Dict]],
                  max_instances: int = MAX_INSTANCES) -> Dict[str, np.ndarray]:
    """Stack into fixed-shape arrays (DetectionFastCollate, loader.py:15-100)."""
    imgs = np.stack([s[0] for s in samples])
    annos = [pad_annotations(s[1], max_instances) for s in samples]
    batch = {
        "image": imgs,
        "bbox": np.stack([a["bbox"] for a in annos]),
        "cls": np.stack([a["cls"] for a in annos]),
        "img_id": np.asarray([_numeric_id(a.get("img_id", -1))
                              for a in annos], np.int64),
    }
    for k in ("difficult", "group_of"):
        if k in annos[0]:
            batch[k] = np.stack([a[k] for a in annos])
    if "img_scale" in annos[0]:
        batch["img_scale"] = np.asarray(
            [a["img_scale"] for a in annos], np.float32)[:, None]
    if "img_size" in annos[0]:
        batch["img_size"] = np.asarray(
            [a["img_size"] for a in annos], np.float32)
    return batch


class PrefetchLoader:
    """Threaded batch producer that keeps a few batches on ``device`` ahead
    of the consumer.

    Host threads decode and transform ``workers`` samples at once; the
    collated batch becomes torch tensors, pinned and copied to the card with
    ``non_blocking=True`` (plain copies for the CPU), and with ``normalize``
    its uint8 images are normalised there (reference PrefetchLoader,
    loader.py:104-170). ``re_prob > 0`` then applies RandomErasing there
    (``re_mode``, up to ``re_count`` rectangles), drawn from a generator on
    the device seeded by (seed, epoch, batch), as the JAX loader seeds
    its key. ``device``: the CUDA card when None (raises without one), or
    the device named.

    Data parallelism: ``process_index`` / ``process_count`` split the
    sample order per process as the JAX loader does (the reference
    samplers, effdet/data/loader.py:207-214): the epoch order (shuffled
    with a seed every process shares, or sequential) is padded by
    wrapping to a multiple of ``process_count``, then strided
    ``order[rank::world]``, so the ranks hold disjoint samples (up to the
    pad's wrapped repeats) and as many batches each.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 workers: int = 4, max_instances: int = MAX_INSTANCES,
                 drop_last: bool = True, prefetch: int = 2,
                 seed: int = 0,
                 device: Optional[Union[str, torch.device]] = None,
                 normalize: bool = True, mean=None, std=None,
                 re_prob: float = 0.0, re_mode: str = "pixel",
                 re_count: int = 1, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} out of range "
                             f"for process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = workers
        self.max_instances = max_instances
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.seed = seed
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.normalize = normalize
        self.mean = mean
        self.std = std
        # RandomErasing after normalisation, on the device (reference
        # PrefetchLoader wiring, effdet/data/loader.py:115-130)
        self.re_prob = re_prob
        self.re_mode = re_mode
        self.re_count = re_count
        self.process_index = process_index
        self.process_count = process_count
        # epoch counter: each __iter__ pass reshuffles with a fresh
        # (seed, epoch) stream, the DistributedSampler.set_epoch semantic
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """This process's sample order of one epoch (a (seed, epoch)
        shuffle every process shares, wrap-padded and strided by rank)."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        world = self.process_count
        if world > 1:
            total = -(-len(order) // world) * world
            if total > len(order):
                order = np.concatenate([order, order[:total - len(order)]])
            order = order[self.process_index::world]
        return order

    def _batches(self, epoch: int) -> List[np.ndarray]:
        """The sample indices of each batch of one epoch."""
        order = self._epoch_order(epoch)
        batches = [order[i:i + self.batch_size]
                   for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        return batches

    def __len__(self):
        per_proc = -(-len(self.dataset) // self.process_count)
        n = per_proc // self.batch_size
        if not self.drop_last and per_proc % self.batch_size:
            n += 1
        return n

    def _to_device(self, batch: Dict[str, np.ndarray], epoch: int = 0,
                   index: int = 0) -> Dict[str, torch.Tensor]:
        on_card = self.device.type == "cuda"
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = t.pin_memory().to(self.device, non_blocking=True) \
                if on_card else t.to(self.device)
        if self.normalize and out["image"].dtype == torch.uint8:
            norm = {}
            if self.mean is not None:
                norm["mean"] = tuple(self.mean)
            if self.std is not None:
                norm["std"] = tuple(self.std)
            out["image"] = normalize_uint8(out["image"], **norm)
            if self.re_prob > 0:
                gen = torch.Generator(device=self.device).manual_seed(
                    hash((self.seed, epoch, index)) & 0x7FFFFFFF)
                out["image"] = random_erasing(
                    out["image"], gen, probability=self.re_prob,
                    mode=self.re_mode, max_count=self.re_count)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        epoch = self._epoch
        self._epoch += 1
        batches = self._batches(epoch)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                if self.device.type == "cuda":      # the thread's own device
                    torch.cuda.set_device(self.device)
                with ThreadPoolExecutor(
                        max_workers=max(1, self.workers)) as pool:
                    for bi, idxs in enumerate(batches):
                        if stop.is_set():
                            return
                        if not len(idxs):       # a rank's empty share
                            q.put({})
                            continue
                        samples = list(pool.map(self.dataset.__getitem__,
                                                idxs))
                        q.put(self._to_device(
                            collate_batch(samples, self.max_instances),
                            epoch, bi))
            except BaseException as e:          # re-raised by the consumer
                failure.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                yield batch
            if failure:
                raise failure[0]
        finally:
            stop.set()
            while t.is_alive():       # unblock a producer waiting on put
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.01)


def create_loader(dataset, input_size: Tuple[int, int], batch_size: int,
                  is_training: bool = False, workers: int = 4,
                  interpolation: str = "bilinear",
                  fill_color: Tuple[int, int, int] = (124, 116, 104),
                  mean=None, std=None, re_prob: float = 0.0,
                  re_mode: str = "pixel", re_count: int = 1,
                  max_instances: int = MAX_INSTANCES, seed: int = 0,
                  distributed: bool = False,
                  device: Optional[Union[str, torch.device]] = None):
    """Dataset + transform + prefetch loader (reference create_loader,
    loader.py:173-232) on ``device`` (the card when None). mean/std default
    to ImageNet; ``re_prob > 0`` erases rectangles of the training batches
    after normalisation (loader.py:115-130). ``distributed=True`` splits
    the samples over the processes of the launched group (rank and world
    size of ``torch.distributed``); outside one it raises."""
    process_index, process_count = 0, 1
    if distributed:
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError(
                "distributed=True needs the process group of a launched "
                "run: start one process a card with torchrun (python -m "
                "torch.distributed.run --nproc-per-node N ...) and "
                "parallel.create_mesh")
        process_index, process_count = dist.get_rank(), dist.get_world_size()
    if getattr(dataset, "transform", None) is None and hasattr(dataset, "transform"):
        tf = (transforms_coco_train(input_size, fill_color=fill_color)
              if is_training else
              transforms_coco_eval(input_size,
                                   interpolation=interpolation,
                                   fill_color=fill_color))
        dataset.transform = tf
    return PrefetchLoader(
        dataset, batch_size=batch_size, shuffle=is_training, workers=workers,
        max_instances=max_instances, drop_last=is_training, seed=seed,
        mean=mean, std=std, re_prob=re_prob if is_training else 0.0,
        re_mode=re_mode, re_count=re_count, device=device,
        process_index=process_index, process_count=process_count)
