"""Deployment inference pipeline: image files -> detections + OOD scores.

Port of ``examples/deploy_infer.py``. The whole serving path on one card:
the native C++ loader (``csrc/libdatacore.so``: threaded libjpeg decode +
letterbox into fixed uint8 canvases) or, where that library does not load,
the same letterbox through PIL, image by image; the canvases go to the
card pinned and ``non_blocking``; ``normalize_uint8`` there, then
EfficientDet forward in bf16, K2 (packed key + energy) and K1 (soft-NMS)
once a batch; detections are mapped back to the original image by the
recorded letterbox scale. The summary line names the decoder that ran and
the device.

Run: python -m ood_object_detection_tpu_torch.examples.deploy_infer \\
        --image-dir /path/to/jpegs [--model efficientdet_d0] \\
        [--batch-size 8] [--out dets.json] [--device cpu]
With no --image-dir, writes a few synthetic JPEGs to a temporary
directory. Without --device it runs on the CUDA card and raises without
one. ``--checkpoint`` takes a variables file of the port
(``train.checkpoint.save_variables`` of the model's ``state_dict()``) or a
reference-format ``.pth`` / ``.pt``; an orbax directory raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch import nn


def load_checkpoint(model: nn.Module, path: str) -> str:
    """Load ``path`` into ``model`` in place: a variables file of the port
    (the model's own ``state_dict`` keys, shapes checked) or a
    reference-format ``.pth`` / ``.pt`` (``utils.checkpoint_convert``, as
    ``create_model(checkpoint_path=...)`` reads it, timm's training
    checkpoints included). Returns which."""
    from ..train.checkpoint import restore_variables
    from ..utils.checkpoint_convert import (load_pytorch_checkpoint,
                                            load_reference)
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path!r} is a directory: the port reads no orbax checkpoint; "
            "pass a variables file of the port or a reference .pth / .pt")
    state = model.state_dict()
    tree = load_reference(path)
    if isinstance(tree, dict) and set(tree) == set(state):
        model.load_state_dict(restore_variables(path, state))
        return "port"
    if not path.endswith((".pth", ".pt")):
        raise ValueError(f"{path!r} holds neither this model's variables "
                         "nor a reference-format .pth / .pt")
    load_pytorch_checkpoint(path, model)
    return "reference"


def _demo_images(directory: str) -> List[str]:
    from PIL import Image
    rng = np.random.default_rng(0)
    paths = []
    for i in range(4):
        img = rng.integers(0, 255, (480, 640, 3)).astype(np.uint8)
        path = os.path.join(directory, f"demo_{i}.jpg")
        Image.fromarray(img).save(path, quality=90)
        paths.append(path)
    return paths


def main(argv: Optional[List[str]] = None) -> List[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--image-dir", default="")
    p.add_argument("--model", default="efficientdet_d0")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-classes", type=int, default=90)
    p.add_argument("--checkpoint", default="",
                   help="a variables file of the port or a reference "
                        ".pth / .pt to load")
    p.add_argument("--score-threshold", type=float, default=0.1)
    p.add_argument("--ood-method", default="energy",
                   choices=["energy", "max_logit", "msp"])
    p.add_argument("--out", default="")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions)")
    args = p.parse_args(argv)

    from ..data import (NativeEvalLoader, PilEvalLoader,
                        native_decode_available, normalize_uint8)
    from ..factory import create_model, resolve_device

    device = resolve_device(args.device)
    if args.image_dir:
        paths = sorted(
            sum((glob.glob(os.path.join(args.image_dir, e))
                 for e in ("*.jpg", "*.jpeg", "*.JPG", "*.png")), []))
        if not paths:
            raise SystemExit(f"no images under {args.image_dir}")
    else:
        tmp = tempfile.mkdtemp(prefix="deploy_infer_demo_")
        paths = _demo_images(tmp)
        print(f"# no --image-dir given; wrote {len(paths)} demo JPEGs to "
              f"{tmp}")

    bench = create_model(args.model, bench_task="predict",
                         num_classes=args.num_classes, soft_nms=True,
                         ood_method=args.ood_method,
                         compute_dtype="bfloat16", device=device)
    if args.checkpoint:
        load_checkpoint(bench.model, args.checkpoint)
    h, w = bench.config.image_size
    loader_cls = (NativeEvalLoader if native_decode_available()
                  else PilEvalLoader)
    loader = loader_cls(paths, target_hw=(h, w), batch_size=args.batch_size)

    results = []
    for batch in loader:
        canvases = torch.from_numpy(batch["image"])
        if device.type == "cuda":
            canvases = canvases.pin_memory()
        canvases = canvases.to(device, non_blocking=True)
        dets, ood = bench.forward_with_ood(normalize_uint8(canvases))
        dets = dets.cpu().numpy()
        ood = ood.cpu().numpy()
        for i, path in enumerate(batch["path"]):
            scale = float(batch["img_scale"][i])
            keep = dets[i, :, 4] >= args.score_threshold
            rows = dets[i, keep]
            results.append({
                "path": path,
                "detections": [
                    {"box_xyxy": [round(float(c) * scale, 2)
                                  for c in r[:4]],
                     "score": round(float(r[4]), 4),
                     "class": int(r[5]),
                     "ood_score": round(float(o), 4)}
                    for r, o in zip(rows, ood[i, keep])],
            })

    summary = {
        "images": len(results),
        "detections": sum(len(r["detections"]) for r in results),
        "decoder": loader.decoder,
        "device": str(device),
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"# wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
