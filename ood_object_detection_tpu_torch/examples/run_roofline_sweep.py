"""Run the roofline sweep and collect its rows (port of the JAX package's
``examples/run_roofline_sweep.py``).

Runs ``examples.train_roofline`` in a subprocess a config (so an
out-of-memory config costs its own row only) and gathers every result,
failures included, into one JSON file (``--out``, by default
``roofline_h100.json`` in the current directory). The configs are the
JAX sweep's:

  D0@512: bs 64 / 128 x freeze_bn none / backbone, and its remat and
          batch probes;
  D4@1024: bs 8 / 16 / 24 x remat, the last two with the FPN cells and
          heads rematted;
  predict: D4@1024 end-to-end inference at bs 16.

Usage:
    python -m ood_object_detection_tpu_torch.examples.run_roofline_sweep \\
        [--out FILE] [--only d0|d4|predict] [--iters 20] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "ood_object_detection_tpu_torch.examples.train_roofline"

D0_CONFIGS = [
    dict(model="efficientdet_d0", batch=64, freeze_bn="none", remat=0),
    dict(model="efficientdet_d0", batch=64, freeze_bn="backbone", remat=0),
    dict(model="efficientdet_d0", batch=128, freeze_bn="none", remat=0),
    dict(model="efficientdet_d0", batch=128, freeze_bn="backbone", remat=0),
    dict(model="efficientdet_d0", batch=128, freeze_bn="none", remat=4),
    dict(model="efficientdet_d0", batch=256, freeze_bn="none", remat=0),
    dict(model="efficientdet_d0", batch=256, freeze_bn="backbone", remat=0),
    dict(model="efficientdet_d0", batch=160, freeze_bn="backbone", remat=0),
    dict(model="efficientdet_d0", batch=192, freeze_bn="backbone", remat=0),
    dict(model="efficientdet_d0", batch=128, freeze_bn="backbone", remat=1),
]
D4_CONFIGS = [
    dict(model="efficientdet_d4", batch=8, freeze_bn="none", remat=0),
    dict(model="efficientdet_d4", batch=8, freeze_bn="none", remat=4),
    dict(model="efficientdet_d4", batch=16, freeze_bn="none", remat=0),
    dict(model="efficientdet_d4", batch=16, freeze_bn="none", remat=7,
         remat_fh=1),
    dict(model="efficientdet_d4", batch=24, freeze_bn="none", remat=7,
         remat_fh=1),
]
PREDICT_CONFIGS = [
    dict(model="efficientdet_d4", batch=16, freeze_bn="none", remat=0,
         task="predict"),
]


def configs(only: str = "") -> List[Dict]:
    out = []
    if only in ("", "d0"):
        out += D0_CONFIGS
    if only in ("", "d4"):
        out += D4_CONFIGS
    if only in ("", "predict"):
        out += PREDICT_CONFIGS
    return out


def parse_result(text: str) -> Optional[Dict]:
    """The roofline result dict in a child's stdout: train_roofline
    pretty-prints it (then a bytes-detail dict), and warnings before it
    may hold braces themselves, so a balanced decode is tried from each
    '{' until one gives a dict with the result's keys."""
    dec, idx = json.JSONDecoder(), 0
    while True:
        start = text.find("{", idx)
        if start < 0:
            return None
        try:
            obj, _ = dec.raw_decode(text[start:])
        except json.JSONDecodeError:
            obj = None
        if isinstance(obj, dict) and "hbm_bytes_per_step" in obj:
            return obj
        idx = start + 1


def command(cfg: Dict, iters: int, device: Optional[str] = None
            ) -> List[str]:
    cmd = [sys.executable, "-m", MODULE,
           "--model", cfg["model"], "--batch", str(cfg["batch"]),
           "--freeze-bn", cfg["freeze_bn"], "--remat", str(cfg["remat"]),
           "--task", cfg.get("task", "train"), "--iters", str(iters)]
    if cfg.get("remat_fh"):
        cmd.append("--remat-fpn-heads")
    if cfg.get("image_size"):
        cmd += ["--image-size", str(cfg["image_size"])]
    if device:
        cmd += ["--device", device]
    return cmd


def run_one(cfg: Dict, iters: int, device: Optional[str] = None,
            timeout: float = 3600) -> Dict:
    """One config in a subprocess: its result row, or an error / OOM row."""
    t0 = time.time()
    proc = subprocess.run(command(cfg, iters, device), capture_output=True,
                          text=True, timeout=timeout, cwd=ROOT)
    wall = time.time() - t0
    if proc.returncode != 0:
        err = "\n".join((proc.stderr or proc.stdout).strip()
                        .splitlines()[-8:])
        kind = "OOM" if "out of memory" in (proc.stderr or "") else "error"
        return {**cfg, "status": kind, "detail": err[-2000:],
                "wall_s": wall}
    obj = parse_result(proc.stdout)
    if obj is None:
        return {**cfg, "status": "error", "wall_s": wall,
                "detail": "no roofline result dict in stdout: "
                          + proc.stdout[-500:]}
    return {**obj, "status": "ok", "wall_s": wall}


def key(c: Dict):
    return (c["model"], c["batch"], c["freeze_bn"], c["remat"],
            int(c.get("remat_fh", 0) or 0), c.get("task", "train"))


def main(argv: Optional[list] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="roofline_h100.json")
    ap.add_argument("--only", default="", choices=["", "d0", "d4", "predict"])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device of every child; the CUDA card when "
                         "omitted")
    ap.add_argument("--rerun-failed", action="store_true",
                    help="re-run rows recorded as OOM / error (by default "
                         "only missing and timed-out rows run)")
    args = ap.parse_args(argv)
    from .train_roofline import PEAK_GBS, PEAK_TFLOPS, card_name

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f).get("results", [])
    done_status = ("ok",) if args.rerun_failed else ("ok", "OOM", "error")
    done = {key(r) for r in results if r.get("status") in done_status}
    on_card = args.device is None or args.device.startswith("cuda")
    card = card_name() if on_card else args.device
    for cfg in configs(args.only):
        if key(cfg) in done:
            print(f"skip (done): {cfg}", flush=True)
            continue
        print(f"running: {cfg}", flush=True)
        try:
            res = run_one(cfg, args.iters, args.device)
        except subprocess.TimeoutExpired:
            res = {**cfg, "status": "timeout"}
        results = [r for r in results if key(r) != key(cfg)] + [res]
        print(json.dumps(res), flush=True)
        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "peaks": {"tflops": PEAK_TFLOPS,
                                               "gbs": PEAK_GBS},
                       "results": results}, f, indent=2)
    print(f"wrote {args.out} ({len(results)} rows)")
    return results


if __name__ == "__main__":
    main()
