"""Serving export: the fused predict graph as one ``torch.export`` artifact.

Port of ``ood_object_detection_tpu.export``. The JAX package serialises
its jitted serving function to StableHLO with ``jax.export``; here
``torch.export`` traces the same computation (backbone + BiFPN + heads +
post-process: K2's key / energy reduce, top-k, box decode, K1's NMS, the
survivors' OOD scores) into an ``ExportedProgram`` with the weights
embedded, saved as ``<path>/serving.pt2`` beside a ``manifest.json``:

- one artifact serves any batch when exported with a symbolic batch
  (``Dim("b")``); K1 takes any batch, so there is no substitute NMS for it,
  as JAX's lax NMS is for its Pallas kernel;
- ``with_preproc`` puts the letterbox + normalise inside, so the inputs are
  ``[B, H, W, 3] uint8`` canvases and ``[B, 2] int32`` true (h, w);
- the hand kernels stay in the program as the custom operators
  ``ood_detection::key_energy_reduce`` and ``ood_detection::batched_nms``
  (the letterbox as ``ood_detection::letterbox_normalize``): on the card
  they launch K2 and K1, on the CPU they run the plain versions. Unlike a
  StableHLO artifact, a ``.pt2`` that holds them needs this package
  installed to load; importing this module registers them.

``load_artifact(path, device)`` moves the program to the device named
(``torch.export.passes.move_to_device_pass``), the card when None: the
port's answer to JAX's lowering platforms.

Typical flow::

    bench = create_model("efficientdet_d0", bench_task="predict",
                         ood_method="energy", compute_dtype="bfloat16")
    ep = export_predict(bench, batch_size=None, with_preproc=True)
    save_artifact("/models/d0_serving", ep, bench)
    ...
    serving = load_artifact("/models/d0_serving")      # on the card
    dets, ood = serving(canvases, true_hw)
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Union

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

# the custom operators a program calls must be registered before it loads:
# these modules register them when imported
from .data.device_preproc import batched_letterbox_normalize
from .factory import resolve_device
from .ops import cuda_labeler, cuda_nms, cuda_reduce  # noqa: F401

ARTIFACT_FILE = "serving.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT = "ood_object_detection_tpu_torch.serving/1"


class _ServingFn(nn.Module):
    """The serving computation: images -> detections (+ OOD scores), or
    with ``with_preproc`` uint8 canvases + true (h, w) -> letterbox +
    normalise -> the same (boxes in the letterboxed frame, as in JAX)."""

    def __init__(self, bench: nn.Module, with_preproc: bool):
        super().__init__()
        self.bench = bench
        self.with_preproc = with_preproc

    def forward(self, *inputs: torch.Tensor):
        if not self.with_preproc:
            return self.bench.forward_with_ood(*inputs)
        canvases, true_hw = inputs
        pre = batched_letterbox_normalize(
            canvases, true_hw, target_hw=tuple(self.bench.config.image_size),
            out_dtype=self.bench.config.compute_dtype)
        return self.bench.forward_with_ood(pre["image"])


def export_predict(bench: nn.Module, batch_size: Optional[int] = None,
                   with_preproc: bool = False
                   ) -> torch.export.ExportedProgram:
    """Export the fused predict path of a ``DetBenchPredict``.

    Args:
      bench: a ``DetBenchPredict`` (``create_model(bench_task='predict')``),
        in eval mode; its weights are embedded in the program.
      batch_size: a fixed batch, or None for a symbolic batch ``Dim("b")``
        (traced at batch 2; one artifact serves every batch size).
      with_preproc: take ``[B, H, W, 3] uint8`` canvases plus ``[B, 2]
        int32`` true (height, width) and letterbox + normalise inside;
        otherwise ``[B, H, W, 3] float32`` normalised images.

    The program is traced on the bench's device and holds its weights
    there; ``load_artifact`` places it on the device a server names.
    Returns a ``torch.export.ExportedProgram``; ``save_artifact`` writes it.
    """
    h, w = bench.config.image_size
    traced_on = next(bench.parameters()).device
    b = 2 if batch_size is None else batch_size
    if with_preproc:
        args = (torch.zeros((b, h, w, 3), dtype=torch.uint8,
                            device=traced_on),
                torch.tensor([[h, w]] * b, dtype=torch.int32,
                             device=traced_on))
    else:
        args = (torch.zeros((b, h, w, 3), dtype=torch.float32,
                            device=traced_on),)
    dynamic = None
    if batch_size is None:
        batch = torch.export.Dim("b")
        dynamic = (tuple({0: batch} for _ in args),)    # for *inputs
    return torch.export.export(_ServingFn(bench, with_preproc).eval(), args,
                               dynamic_shapes=dynamic)


def _user_inputs(ep: torch.export.ExportedProgram):
    names = set(ep.graph_signature.user_inputs)
    return [n.meta["val"] for n in ep.graph.nodes
            if n.op == "placeholder" and n.name in names]


def _has_preproc(ep: torch.export.ExportedProgram) -> bool:
    """A preproc artifact's signature is (uint8 canvases, int32 true_hw)."""
    inputs = _user_inputs(ep)
    return len(inputs) == 2 and inputs[0].dtype == torch.uint8


def _manifest(bench: Optional[nn.Module],
              ep: torch.export.ExportedProgram) -> Dict[str, Any]:
    inputs = _user_inputs(ep)
    manifest: Dict[str, Any] = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "device": str(inputs[0].device),
    }
    if bench is None:
        return manifest
    cfg = bench.config
    return {
        **manifest,
        "model": getattr(cfg, "name", ""),
        "image_size": list(cfg.image_size),
        "num_classes": int(cfg.num_classes),
        "max_det_per_image": int(cfg.max_det_per_image),
        "soft_nms": bool(cfg.soft_nms),
        "topk_method": str(cfg.topk_method),
        "ood_method": bench.ood_method,
        "with_preproc": _has_preproc(ep),
        "input_signature": [
            {"shape": [str(d) for d in t.shape],
             "dtype": str(t.dtype).replace("torch.", "")} for t in inputs],
        "output": "detections [B, max_det, 6] rows "
                  "[xmin, ymin, xmax, ymax, score, class]"
                  + ("; ood [B, max_det]" if bench.ood_method else ""),
    }


def save_artifact(path: str, ep: torch.export.ExportedProgram,
                  bench: Optional[nn.Module] = None,
                  extra_manifest: Optional[Dict[str, Any]] = None) -> str:
    """Write ``<path>/serving.pt2`` + ``<path>/manifest.json``.

    Whether the artifact embeds the uint8 preproc is read from the
    program's input signature: no flag to keep in sync.
    """
    os.makedirs(path, exist_ok=True)
    torch.export.save(ep, os.path.join(path, ARTIFACT_FILE))
    manifest = _manifest(bench, ep)
    if extra_manifest:
        manifest.update(extra_manifest)
    with open(os.path.join(path, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
    return path


class ServingModule:
    """A loaded serving artifact: ``module(*inputs)`` runs the whole path
    and returns (detections, OOD scores or None). The program checks that
    its inputs lie on its device; inputs elsewhere (true (h, w) on the
    host, say) are copied there first."""

    def __init__(self, program: torch.export.ExportedProgram,
                 manifest: Optional[Dict[str, Any]] = None):
        self.program = program
        self.manifest = manifest or {}
        self.device = _user_inputs(program)[0].device
        self._call = program.module()

    def __call__(self, *inputs: torch.Tensor):
        return self._call(*(t.to(self.device) for t in inputs))


def load_artifact(path: str,
                  device: Optional[Union[str, torch.device]] = None
                  ) -> ServingModule:
    """Load a directory written by ``save_artifact`` (or a ``.pt2`` file)
    onto ``device``: the CUDA card when None (raises without one), or the
    device named."""
    device = resolve_device(device)
    manifest = None
    program_path = path
    if os.path.isdir(path):
        program_path = os.path.join(path, ARTIFACT_FILE)
        manifest_path = os.path.join(path, MANIFEST_FILE)
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
    ep = torch.export.load(program_path)
    ep = move_to_device_pass(ep, str(device))
    return ServingModule(ep, manifest)
