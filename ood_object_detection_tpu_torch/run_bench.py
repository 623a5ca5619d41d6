"""The benchmark entry point: end-to-end EfficientDet throughput on one
CUDA card (port of the JAX package's root ``bench.py``).

    python -m ood_object_detection_tpu_torch.run_bench

Prints one JSON line a measured row, ``{"metric": ..., "value": N,
"unit": "images/sec", "vs_baseline": null}``. The default run prints the
train-step row and the exact-top-k inference row first, and always ends
with the north-star inference row (fused preproc + forward + soft-NMS +
energy OOD at D0@512, bf16, batch 128); an extra row that fails prints an
error row instead and the north-star row still runs. ``BENCH_EXTRA=0``
prints the north-star row alone.

Modes (``BENCH_MODE``): ``predict`` (default), ``train`` (one full train
step: K3 -> K4 labeling, forward, loss, backward, clipped SGD, EMA),
``meta`` (one MAML episode's meta-gradients) and ``loader`` (host JPEG
decode + letterbox). The ``BENCH_*`` variables and their defaults are the
JAX bench's: MODE, MODEL, BATCH, SOFT_NMS, ITERS, DTYPE, EXTRA, TOPK,
PREPROC, REMAT, REMAT_FPN_HEADS, FREEZE_BN, LOADER_SRC, META_QRY,
META_SUP; and ``BENCH_DEVICE``: the CUDA card when unset (the run fails
without one), ``cpu`` for the plain kernel versions on the host.

Where it differs from the JAX bench:
- timing: CUDA events around back-to-back eager calls, the median of
  three runs (``utils.benchmark.device_time``), not a jitted loop with a
  perturbed carry;
- ``vs_baseline`` is null: the JAX bench divides by a per-TPU-chip
  target, which says nothing about this card;
- values are not rounded;
- the loader row decodes with the native C++ core where it loads (the row
  says "native C++ loader") and with PIL where it does not ("PIL
  loader"), where the JAX bench prints an error row.

Each mode has a builder returning ``(fn, args)`` (the timed call and its
arguments) and a part that times it and prints the row; the builders
take model-config overrides, which the tests use to shrink the model.
"""
from __future__ import annotations

import glob
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .factory import create_model, create_model_from_config, resolve_device
from .utils.benchmark import device_time

NUM_CLASSES = 90
LOADER_HW = (512, 512)
LOADER_IMAGES = 256


def env(name: str, default: str) -> str:
    return os.environ.get("BENCH_" + name, default)


def bench_device() -> torch.device:
    """``BENCH_DEVICE``, or the CUDA card (raises without one)."""
    return resolve_device(env("DEVICE", "") or None)


def row(metric: str, value: float, unit: str = "images/sec",
        **extra) -> Dict:
    out = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": None, **extra}
    print(json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------- predict

def predict_metric(model_name: str, image_size: int, batch_size: int, *,
                   soft_nms: bool, topk_method: str,
                   with_preproc: bool) -> str:
    """The JAX bench's name of a predict row."""
    stages = "preproc+fwd+NMS+OOD" if with_preproc else "fwd+NMS+OOD"
    stages = stages.replace("NMS", "softNMS" if soft_nms else "NMS")
    if topk_method != "per_anchor":
        stages += f", topk={topk_method}"
    return (f"{model_name}@{image_size} e2e inference ({stages}), "
            f"bs={batch_size}")


def build_predict(model_name: str, batch_size: int, dtype: str, *,
                  soft_nms: bool, topk_method: str, with_preproc: bool,
                  device, **overrides) -> Tuple[Callable, Tuple]:
    """The north-star call: uint8 canvases (seed 0) -> letterbox +
    normalise in ``dtype`` -> forward -> K2 -> top-k -> K1 -> energy OOD;
    with ``with_preproc`` False, f32 images straight into the forward.
    Returns (fn, args); ``fn(*args)`` is (detections, OOD scores) and
    ``fn.bench`` the predict bench."""
    from .data.device_preproc import batched_letterbox_normalize

    bench = create_model(model_name, bench_task="predict",
                         num_classes=NUM_CLASSES, soft_nms=soft_nms,
                         ood_method="energy", compute_dtype=dtype,
                         topk_method=topk_method, device=device, **overrides)
    h, w = bench.config.image_size
    rng = np.random.default_rng(0)
    if with_preproc:
        canvases = torch.from_numpy(rng.integers(
            0, 255, (batch_size, h, w, 3)).astype(np.uint8)).to(device)
        true_hw = torch.from_numpy(rng.integers(
            h // 2, h, (batch_size, 2)).astype(np.int32)).to(device)

        def fn(cv, hw):
            # resampled in the model's compute dtype, as the JAX bench
            pre = batched_letterbox_normalize(cv, hw, target_hw=(h, w),
                                              out_dtype=dtype)
            return bench.forward_with_ood(pre["image"])
        args = (canvases, true_hw)
    else:
        x = torch.from_numpy(rng.uniform(
            -2, 2, (batch_size, h, w, 3)).astype(np.float32)).to(device)

        def fn(im):
            return bench.forward_with_ood(im)
        args = (x,)
    fn.bench = bench
    return fn, args


def predict_bench(model_name: str, batch_size: int, dtype: str,
                  n_iters: int, *, soft_nms: bool, topk_method: str,
                  device, **overrides) -> Dict:
    """One end-to-end inference row."""
    with_preproc = env("PREPROC", "1") == "1"
    fn, args = build_predict(model_name, batch_size, dtype,
                             soft_nms=soft_nms, topk_method=topk_method,
                             with_preproc=with_preproc, device=device,
                             **overrides)
    t = device_time(fn, args, iters=n_iters, device=device)
    return row(predict_metric(model_name, fn.bench.config.image_size[0],
                              batch_size, soft_nms=soft_nms,
                              topk_method=topk_method,
                              with_preproc=with_preproc), batch_size / t)


# ------------------------------------------------------------------ train

def train_metric(model_name: str, image_size: int, dtype: str,
                 freeze_bn: str, batch_size: int) -> str:
    return (f"{model_name}@{image_size} train step ({dtype}, "
            f"freeze_bn={freeze_bn}), bs={batch_size}")


def train_batch(batch_size: int, image_size: int, device) -> Dict:
    """The JAX bench's batch (seed 0): normal images, 16 boxes an image."""
    h = image_size
    rng = np.random.default_rng(0)
    m = 16
    yx = rng.uniform(0, h - 64, (batch_size, m, 2)).astype(np.float32)
    hw_box = rng.uniform(16, 64, (batch_size, m, 2)).astype(np.float32)
    batch = {
        "image": rng.normal(0, 1, (batch_size, h, h, 3)).astype(np.float32),
        "bbox": np.concatenate([yx, yx + hw_box], -1),
        "cls": rng.integers(1, 90, (batch_size, m)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_train(model_name: str, batch_size: int, dtype: str, *,
                freeze_bn: str, remat: int = 0, remat_fpn_heads: bool = False,
                device, **overrides) -> Tuple[Callable, Tuple]:
    """One full train step (K3 -> K4 labeling, forward, loss, backward,
    clipped SGD, EMA) on the JAX bench's batch. Returns (fn, args) with
    args (state, batch); ``fn(*args)`` takes one step and returns its
    metrics."""
    from .config import default_detection_train_config, get_efficientdet_config
    from .train import create_train_state, make_train_step

    cfg = get_efficientdet_config(model_name, num_classes=NUM_CLASSES
                                  ).replace(compute_dtype=dtype, **overrides)
    if remat:
        # checkpoint the first N backbone stages (the largest activations)
        cfg = cfg.replace(backbone_args={**(cfg.backbone_args or {}),
                                         "remat_stages": remat})
    if remat_fpn_heads:
        cfg = cfg.replace(remat_fpn=True, remat_heads=True)
    bench = create_model_from_config(cfg, bench_task="train", seed=0,
                                     device=device)
    tcfg = default_detection_train_config()
    state, tx = create_train_state(bench, tcfg)
    step = make_train_step(bench, tx, bench.anchors, tcfg,
                           freeze_bn=freeze_bn)

    def fn(s, b):
        with torch.enable_grad():
            return step(s, b)[1]
    return fn, (state, train_batch(batch_size, cfg.image_size[0], device))


def train_bench(model_name: str, batch_size: int, dtype: str, n_iters: int,
                device, **overrides) -> Dict:
    """One train-step row (``BENCH_MODE=train``)."""
    freeze_bn = env("FREEZE_BN", "backbone")
    fn, args = build_train(
        model_name, batch_size, dtype, freeze_bn=freeze_bn,
        remat=int(env("REMAT", "0")),
        remat_fpn_heads=env("REMAT_FPN_HEADS", "0") == "1", device=device,
        **overrides)
    t = device_time(fn, args, iters=n_iters, device=device)
    image_size = args[1]["image"].shape[1]
    return row(train_metric(model_name, image_size, dtype, freeze_bn,
                            batch_size), batch_size / t)


# ----------------------------------------------------------------- loader

def loader_metric(native: bool, batch_size: int) -> str:
    kind = "native C++" if native else "PIL"
    return (f"{kind} loader: jpeg decode + letterbox to "
            f"{LOADER_HW[0]}x{LOADER_HW[1]}, bs={batch_size}")


def loader_paths(src: str, out_dir: str, count: int = LOADER_IMAGES
                 ) -> List[str]:
    """Up to 512 JPEGs of ``src``, or ``count`` synthetic noise JPEGs
    (seed 0, about VGA) written into ``out_dir``."""
    if src:
        paths = sorted(p for pat in ("*.jpg", "*.jpeg", "*.JPG", "*.JPEG")
                       for p in glob.glob(os.path.join(src, pat)))[:512]
        if not paths:
            raise SystemExit(f"BENCH_LOADER_SRC={src}: no jpeg files found")
        return paths
    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i in range(count):
        h, w = int(rng.integers(360, 720)), int(rng.integers(480, 960))
        img = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        p = os.path.join(out_dir, f"im{i}.jpg")
        Image.fromarray(img).save(p, quality=90)
        paths.append(p)
    return paths


def build_loader(batch_size: int, paths: List[str]
                 ) -> Tuple[Callable, Tuple]:
    """One batch of JPEG decode + letterbox to 512 x 512 uint8 canvases on
    the host: the native core's threaded ``load_letterbox_batch`` where it
    loads, else PIL image by image (``pil_letterbox``, the eval loaders'
    PIL path). Returns (fn, (the first batch's paths,)); ``fn(chunk)``
    loads one chunk and ``fn.native`` says which path."""
    from .data import native_decode

    if native_decode.available():
        def fn(chunk):
            _, _, _, rc = native_decode.load_letterbox_batch(chunk, LOADER_HW)
            if int(rc.sum()):
                raise RuntimeError(f"{int((rc != 0).sum())} images failed "
                                   "to decode")
            return len(chunk)
        fn.native = True
    else:
        def fn(chunk):
            for path in chunk:
                native_decode.pil_letterbox(path, LOADER_HW)
            return len(chunk)
        fn.native = False
    return fn, (paths[:batch_size],)


def loader_bench(batch_size: int, n_iters: int,
                 num_images: int = LOADER_IMAGES) -> Dict:
    """One host input-pipeline row (``BENCH_MODE=loader``): images a
    second over ``n_iters`` batches after a warm-up batch, by the host
    clock."""
    with tempfile.TemporaryDirectory(prefix="loader_bench_") as tmp:
        paths = loader_paths(env("LOADER_SRC", ""), tmp, num_images)
        fn, args = build_loader(batch_size, paths)
        fn(*args)                   # warm the thread pool and page cache
        n_total = 0
        t0 = time.perf_counter()
        for i in range(n_iters):
            start = (i * batch_size) % max(len(paths) - batch_size, 1)
            n_total += fn(paths[start:start + batch_size])
        dt = time.perf_counter() - t0
    return row(loader_metric(fn.native, batch_size), n_total / dt)


# ------------------------------------------------------------------- meta

def meta_metric(model_name: str, dtype: str, meta_cfg, sup: int,
                qry: int) -> str:
    qry_imgs = meta_cfg.num_qry + meta_cfg.num_zero_images
    return (f"{model_name} MAML episode step ({dtype}, "
            f"{meta_cfg.num_sup}sup@{sup}, {qry_imgs}qry@{qry}, "
            f"{meta_cfg.steps} inner)")


def build_meta(model_name: str, dtype: str, qry: int, sup: int, *, device,
               **overrides) -> Tuple[Callable, Tuple]:
    """One MAML episode's meta-gradients (supports' features, projection +
    pseudo-labels, the inner head step, the queries' loss, the outer
    backward): the JAX bench's episode (6 synthetic categories, 25 supports
    at ``sup`` px, 25 + 6 queries at ``qry`` px, 1 inner step, one class),
    built by ``EpisodicDataset`` on ``device`` (K3 -> K4 label it there).
    Returns (fn, (episode,)); ``fn(episode)`` is ``MetaTrainer.
    episode_grads(episode, phase_a=False)`` and ``fn.meta_cfg`` the
    MetaConfig."""
    from .config import get_efficientdet_config
    from .data.episodic import EpisodicDataset, SyntheticEpisodeSource
    from .meta import MetaConfig, MetaTrainer, ProjectionNet

    meta_cfg = MetaConfig(img_size=sup, qry_img_size=qry)
    model_cfg = get_efficientdet_config(model_name, num_classes=1).replace(
        compute_dtype=dtype, **{**overrides, "image_size": (qry, qry)})
    model = create_model_from_config(model_cfg, seed=0, device=device)
    proj = ProjectionNet(model_cfg.fpn_channels, meta_cfg.proj_size,
                         meta_cfg.proj_depth, dot_mult_init=meta_cfg.dot_mult,
                         dot_add_init=meta_cfg.dot_add)
    proj.init_weights(torch.Generator().manual_seed(1))
    src = SyntheticEpisodeSource(num_cats=6, img_hw=(sup, sup))
    cats = list(range(1, 7))
    dataset = EpisodicDataset(src.support_source(cats), src, model_cfg,
                              meta_cfg, train_cats=cats[:4],
                              val_cats=cats[4:], val_freq=10 ** 9,
                              device=device)
    trainer = MetaTrainer(model, proj, meta_cfg, model_cfg,
                          dataset.builder.proj_level_sizes, device=device)
    episode = next(iter(dataset))

    def fn(batch):
        return trainer.episode_grads(batch, phase_a=False)
    fn.meta_cfg = meta_cfg
    return fn, (episode,)


def meta_bench(model_name: str, n_iters: int, device, **overrides) -> Dict:
    """One MAML episode row (``BENCH_MODE=meta``): episodes a second."""
    qry = int(env("META_QRY", "640"))
    sup = int(env("META_SUP", "256"))
    dtype = env("DTYPE", "bfloat16")
    fn, args = build_meta(model_name, dtype, qry, sup, device=device,
                          **overrides)
    t = device_time(fn, args, iters=n_iters, device=device)
    return row(meta_metric(model_name, dtype, fn.meta_cfg, sup, qry),
               1.0 / t, unit="episodes/sec")


# ------------------------------------------------------------------- main

def error_row(exc: BaseException) -> Dict:
    return row("extra bench row failed", 0, error=f"{type(exc).__name__}: "
               f"{exc}"[:400])


def main(**overrides) -> List[Dict]:
    """Run the mode ``BENCH_MODE`` names; returns the rows printed.
    ``overrides`` go into every model config (the tests' small models)."""
    try:
        device = bench_device()
    except RuntimeError as e:
        raise SystemExit(f"run_bench: {e} (BENCH_DEVICE=cpu runs the plain "
                         "kernel versions on the host)") from e
    model_name = env("MODEL", "efficientdet_d0")
    batch_size = int(env("BATCH", "128"))
    soft_nms = env("SOFT_NMS", "1") == "1"
    n_iters = int(env("ITERS", "20"))
    dtype = env("DTYPE", "bfloat16")
    mode = env("MODE", "predict")
    if mode == "train":
        return [train_bench(model_name, batch_size, dtype, n_iters, device,
                            **overrides)]
    if mode == "meta":
        return [meta_bench(model_name, n_iters, device, **overrides)]
    if mode == "loader":
        return [loader_bench(batch_size, n_iters)]
    if mode != "predict":
        raise SystemExit(f"run_bench: BENCH_MODE={mode!r} is not one of "
                         "predict, train, meta, loader")
    rows = []
    if env("EXTRA", "1") == "1":
        extras = (
            lambda: train_bench(model_name, batch_size, dtype, n_iters,
                                device, **overrides),
            lambda: predict_bench(model_name, batch_size, dtype, n_iters,
                                  soft_nms=soft_nms, topk_method="exact",
                                  device=device, **overrides))
        for extra in extras:
            try:
                rows.append(extra())
            except Exception as e:       # the north-star row still runs
                rows.append(error_row(e))
    rows.append(predict_bench(model_name, batch_size, dtype, n_iters,
                              soft_nms=soft_nms,
                              topk_method=env("TOPK", "per_anchor"),
                              device=device, **overrides))
    return rows


def finite_rows(rows: List[Dict]) -> bool:
    """Every row positive, finite and without an error."""
    return all("error" not in r and math.isfinite(r["value"])
               and r["value"] > 0 for r in rows)


if __name__ == "__main__":
    main()
