"""Roofline of the detection train step or the end-to-end predict path
(port of the JAX package's ``examples/train_roofline.py``).

Builds the same call as ``run_bench`` (``BENCH_MODE=train``'s step, or
with ``--task predict`` the north-star predict call: uint8 canvases ->
letterbox + normalise -> forward -> K2 -> top-k -> K1 -> energy OOD) and
reports

* its FLOPs and bytes per call, counted over one call:
  - FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
    matrix products, forward and backward; the convolutions' backward by
    ``conv_backward_flop``, which counts grouped convolutions right) plus
    one operation an output element of every pointwise op;
  - bytes: every dispatched op's tensor inputs read once and outputs
    written once (views and allocations free). That is the traffic an
    unfused eager program issues, not what the card's caches let through
    to memory; XLA's cost analysis, which the JAX tool reads, counts its
    fused program's instead;
* the measured time a call (CUDA events, ``utils.benchmark.device_time``);
* the roofline: the time bound if the call were purely memory-bound
  (bytes / peak bandwidth) or purely compute-bound (FLOPs / peak rate),
  and the share of each that the measured time reaches.

Peaks are the H100 SXM's published dense rates for the call's dtype
(989 TFLOP/s bf16, 495 TF32, 67 f32; 3.35 TB/s); ROOFLINE_PEAK_TFLOPS /
ROOFLINE_PEAK_GBS override them. The output names the card and its power
limit (nvidia-smi). Key names are the JAX tool's, with
``tensor_core_utilization`` for its ``mxu_utilization``.

Usage:
    python -m ood_object_detection_tpu_torch.examples.train_roofline \\
        [--task train|predict] [--batch 128] [--model efficientdet_d0] \\
        [--dtype bfloat16] [--freeze-bn none] [--remat N] \\
        [--remat-fpn-heads] [--iters 20] [--profile-dir D] \\
        [--skip-measure] [--device cpu] [--image-size N]
"""
from __future__ import annotations

import argparse
import collections
import json
import math
import os
import subprocess
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

# H100 SXM, dense (NVIDIA data sheet, 700 W): TFLOP/s by compute dtype
PEAK_TFLOPS = {"bfloat16": 989.0, "float16": 989.0, "tf32": 495.0,
               "float32": 67.0}
PEAK_GBS = 3350.0
FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "resize_", "set_", "_local_scalar_dense", "record_stream"}
# pointwise-tagged ops that only move data: bytes, no operations
COPY_OPS = {"clone", "copy_", "_to_copy", "copy", "fill_", "zero_"}


def _touched_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s elements, at most its storage's (an expanded view
    reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class TrafficMode(TorchDispatchMode):
    """Counts, for every op dispatched inside it, the bytes of its tensor
    inputs (each distinct tensor once) and outputs, and one operation an
    output element of a pointwise op that computes (copies and fills do
    not). Views and allocations count nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.pointwise_flops = 0
        self.by_op: Dict[str, int] = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if func.is_view or name in FREE_OPS:
            return out
        seen, moved = set(), 0
        for t in tree_flatten((args, kwargs or {}))[0]:
            if isinstance(t, torch.Tensor) and id(t) not in seen:
                seen.add(id(t))
                moved += _touched_bytes(t)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        moved += sum(_touched_bytes(t) for t in outs)
        if torch.Tag.pointwise in func.tags and name not in COPY_OPS:
            self.pointwise_flops += sum(t.numel() for t in outs)
        self.bytes += moved
        self.by_op[name] += moved
        return out


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                       _padding, _dilation, transposed, _output_padding,
                       _groups, output_mask, out_shape=None, **_) -> int:
    """FLOPs of ``aten.convolution_backward``: each gradient asked for
    (input, weight) costs the forward's multiply-adds, two operations
    each. FlopCounterMode's own formula leaves the groups out of the
    weight gradient and so counts a depthwise convolution's C times
    over."""
    forward_out = x_shape if transposed else grad_out_shape
    macs = math.prod(forward_out) * math.prod(w_shape[1:])
    return 2 * macs * (int(output_mask[0]) + int(output_mask[1]))


def count_call(fn: Callable, args: Tuple) -> Dict:
    """FLOPs and bytes of one ``fn(*args)`` (see the module docstring)."""
    aten = torch.ops.aten
    with FlopCounterMode(display=False, custom_mapping={
            aten.convolution_backward: conv_backward_flop}) as flops, \
            TrafficMode() as traffic:
        fn(*args)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    matmul = float(flops.get_total_flops())
    return {"flops": matmul + traffic.pointwise_flops,
            "matmul_flops": matmul,
            "pointwise_flops": float(traffic.pointwise_flops),
            "bytes": float(traffic.bytes), "by_op": dict(traffic.by_op)}


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them, or
    'not read' where it does not run."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def peaks(dtype: str) -> Tuple[float, float]:
    """(TFLOP/s, GB/s) of the card for ``dtype``: the environment's
    ROOFLINE_PEAK_TFLOPS / ROOFLINE_PEAK_GBS, else the H100's."""
    key = dtype
    if dtype == "float32" and torch.backends.cudnn.allow_tf32:
        key = "tf32"
    return (float(os.environ.get("ROOFLINE_PEAK_TFLOPS", PEAK_TFLOPS[key])),
            float(os.environ.get("ROOFLINE_PEAK_GBS", PEAK_GBS)))


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="efficientdet_d0")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--freeze-bn", default="none",
                    choices=["none", "backbone", "all"])
    ap.add_argument("--remat", type=int, default=0,
                    help="gradient-checkpoint the first N backbone stages "
                         "(run_bench's BENCH_REMAT)")
    ap.add_argument("--remat-fpn-heads", action="store_true",
                    help="also gradient-checkpoint the FPN cells and heads")
    ap.add_argument("--task", default="train", choices=["train", "predict"],
                    help="train = full train step (default); predict = "
                         "end-to-end inference (preproc+fwd+softNMS+OOD, "
                         "run_bench's north-star call)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--profile-dir", default="",
                    help="also write a torch.profiler chrome trace of 3 "
                         "calls here")
    ap.add_argument("--skip-measure", action="store_true",
                    help="counts only (no timed run)")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card when omitted")
    ap.add_argument("--image-size", type=int, default=0,
                    help="override the model's image size (0: the "
                         "model's own)")
    return ap


def build_call(args, device) -> Tuple[Callable, Tuple]:
    """``run_bench``'s builder for ``args.task``."""
    from .. import run_bench

    overrides = {}
    if args.image_size:
        overrides["image_size"] = (args.image_size, args.image_size)
    if args.task == "predict":
        return run_bench.build_predict(
            args.model, args.batch, args.dtype, soft_nms=True,
            topk_method="per_anchor", with_preproc=True, device=device,
            **overrides)
    return run_bench.build_train(
        args.model, args.batch, args.dtype, freeze_bn=args.freeze_bn,
        remat=args.remat, remat_fpn_heads=args.remat_fpn_heads,
        device=device, **overrides)


def main(argv: Optional[list] = None) -> Dict:
    args = build_argparser().parse_args(argv)
    from ..factory import resolve_device
    from ..utils.benchmark import device_time
    from ..utils.profiling import trace

    device = resolve_device(args.device)
    fn, call_args = build_call(args, device)
    counts = count_call(fn, call_args)
    peak_tflops, peak_gbs = peaks(args.dtype)
    flops, nbytes = counts["flops"], counts["bytes"]
    out = {
        "model": args.model, "task": args.task, "batch": args.batch,
        "dtype": args.dtype, "freeze_bn": args.freeze_bn,
        "remat": args.remat, "remat_fh": int(args.remat_fpn_heads),
        "device": str(device),
        "card": card_name() if device.type == "cuda" else "cpu",
        "peaks": {"tflops": peak_tflops, "gbs": peak_gbs},
        "bytes_counted": "eager per-op traffic: each dispatched op's "
                         "inputs read once, outputs written once",
        "flops_per_step": flops,
        "matmul_flops_per_step": counts["matmul_flops"],
        "pointwise_flops_per_step": counts["pointwise_flops"],
        "hbm_bytes_per_step": nbytes,
        "hbm_gb_per_image": nbytes / args.batch / 1e9,
        "t_compute_bound_ms": flops / (peak_tflops * 1e12) * 1e3,
        "t_hbm_bound_ms": nbytes / (peak_gbs * 1e9) * 1e3,
    }
    if not args.skip_measure:
        t = device_time(fn, call_args, iters=args.iters, device=device)
        out["t_measured_ms"] = t * 1e3
        out["images_per_sec"] = args.batch / t
        out["hbm_bw_utilization"] = out["t_hbm_bound_ms"] / out["t_measured_ms"]
        out["tensor_core_utilization"] = (out["t_compute_bound_ms"]
                                          / out["t_measured_ms"])
        out["arithmetic_intensity_flops_per_byte"] = (
            flops / nbytes if nbytes else float("nan"))
    if args.profile_dir:
        with trace(args.profile_dir):
            for _ in range(3):
                fn(*call_args)
        out["profile_dir"] = args.profile_dir
        out["profile_calls"] = 3
    print(json.dumps(out, indent=2))
    top = sorted(counts["by_op"].items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({"bytes_accessed_detail": dict(top)}, indent=2))
    return out


if __name__ == "__main__":
    main()
