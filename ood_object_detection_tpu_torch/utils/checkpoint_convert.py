"""Reference-format effdet checkpoints (``.pth`` / ``.pt``) into the
port's model.

The name rules and ``extract_state_dict`` are copied from
``ood_object_detection_tpu.utils.checkpoint_convert``: a torch state_dict
of the reference's names becomes the JAX package's ``{"params": ...,
"batch_stats": ...}`` tree, which ``utils.from_jax.load_jax_variables``
then loads, so that one mapping (the JAX tree <-> the port's modules)
stays the truth; ``merge_into_variables`` is the JAX package's graft of
such a tree onto a variables tree, in numpy. Checkpoints are read from a
local path only, by ``load_reference``: ``torch.load(...,
weights_only=True)`` with ``argparse.Namespace`` allowed, the ``args``
that timm's ``CheckpointSaver`` pickles into a training checkpoint.

Layout rules:
  conv weight   torch [out, in/groups, kh, kw] -> flax kernel [kh, kw, in/groups, out]
  depthwise     torch [C, 1, kh, kw]           -> flax [kh, kw, 1, C]
  linear weight torch [out, in]                -> flax kernel [in, out]
  BN            weight/bias -> params scale/bias;
                running_mean/var -> batch_stats mean/var
"""
from __future__ import annotations

import argparse
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .from_jax import load_jax_variables


def _to_numpy(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _translate_name(name: str) -> Optional[Tuple[Tuple[str, ...], str, str]]:
    """torch param name -> (flax path, leaf name, collection) or None."""
    name = re.sub(r"^(module|model)\.", "", name)

    # --- leaf kind ---
    leaf = name.split(".")[-1]
    if leaf in ("num_batches_tracked",):
        return None
    collection = "params"
    if leaf == "running_mean":
        flax_leaf = "mean"
        collection = "batch_stats"
    elif leaf == "running_var":
        flax_leaf = "var"
        collection = "batch_stats"
    elif leaf == "weight":
        flax_leaf = "kernel"      # may become 'scale' for norms (fixed below)
    elif leaf == "bias":
        flax_leaf = "bias"
    elif leaf == "edge_weights":
        flax_leaf = "edge_weights"
    else:
        flax_leaf = leaf

    body = name.rsplit(".", 1)[0] if "." in name else ""
    parts = body.split(".") if body else []

    out: List[str] = []
    i = 0
    is_bn = False
    while i < len(parts):
        p = parts[i]
        if p == "backbone":
            out.append("backbone")
            i += 1
            if i < len(parts) and parts[i] == "blocks":
                stage, block = parts[i + 1], parts[i + 2]
                out.append(f"blocks_{stage}_{block}")
                i += 3
            elif i < len(parts) and parts[i] == "conv_stem":
                out.append("conv_stem")
                i += 1
            elif i < len(parts) and parts[i] in ("bn1", "bn_stem"):
                out.append("bn_stem")
                is_bn = True
                i += 1
        elif p == "fpn":
            out.append("fpn")
            i += 1
            if i < len(parts) and parts[i] == "resample":
                out.append(f"resample_{parts[i + 1]}")
                i += 2
            elif i < len(parts) and parts[i] == "cell":
                out.append(f"cell_{parts[i + 1]}")
                i += 2
                if i < len(parts) and parts[i] == "fnode":
                    out.append(f"fnode_{parts[i + 1]}")
                    i += 2
                if i < len(parts) and parts[i] == "combine":
                    out.append("combine")
                    i += 1
                    if i < len(parts) and parts[i] == "resample":
                        out.append(f"resample_{parts[i + 1]}")
                        i += 2
                elif i < len(parts) and parts[i] == "after_combine":
                    out.append("after_combine_conv")
                    i += 1
                    if i < len(parts) and parts[i] == "conv":
                        i += 1   # flatten .conv
        elif p in ("class_net", "box_net"):
            out.append(p)
            i += 1
            if i < len(parts) and parts[i] == "conv_rep":
                out.append(f"conv_rep_{parts[i + 1]}")
                i += 2
            elif i < len(parts) and parts[i] == "bn_rep":
                out.append(f"bn_rep_{parts[i + 1]}_{parts[i + 2]}")
                is_bn = True
                i += 3
                if i < len(parts) and parts[i] == "bn":
                    i += 1       # flatten .bn
            elif i < len(parts) and parts[i] == "predict":
                out.append("predict")
                i += 1
        elif p in ("bn", "bn1", "bn2", "bn3"):
            out.append("bn" if p == "bn" else p)
            is_bn = True
            i += 1
        elif p in ("conv", "conv_dw", "conv_pw", "conv_pwl", "conv_exp",
                   "downsample", "se", "conv_reduce", "conv_expand",
                   "projection"):
            out.append(p)
            i += 1
            # timm MixedConv2d is a ModuleDict with integer keys
            # (conv_dw.0.weight ...). The mixed DEPTHWISE convs stay
            # separate flax convs (conv_dw/conv_dw_<i>); the mixed
            # 1x1 pw/pwl convs are merged into one grouped kernel by
            # convert_state_dict's pre-pass and never reach here.
            if i < len(parts) and parts[i].isdigit() and p == "conv_dw":
                out.append(f"conv_dw_{parts[i]}")
                i += 1
        elif p.isdigit():
            # Sequential index (e.g. projection.0) — keep as dense_{i}
            out.append(f"dense_{p}")
            i += 1
        else:
            out.append(p)
            i += 1

    if is_bn and flax_leaf == "kernel":
        flax_leaf = "scale"
    return tuple(out), flax_leaf, collection


def _convert_tensor(arr: np.ndarray, flax_leaf: str) -> np.ndarray:
    if flax_leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (2, 3, 1, 0))
    if flax_leaf == "kernel" and arr.ndim == 2:
        return np.transpose(arr, (1, 0))
    return arr


def _set_in(tree: Dict, path: Tuple[str, ...], leaf: str, value):
    node = tree
    for p in path:
        node = node.setdefault(p, {})
    node[leaf] = value


_MIXED_PW_RE = re.compile(r"^(.*\.conv_pwl?)\.(\d+)\.weight$")


def _merge_mixed_pointwise(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """Fold timm MixedConv 1x1 groups into single grouped-conv weights.

    MixNet's grouped pointwise convs (timm a1.1/p1.1) are stored as
    MixedConv2d submodules `conv_pw.0.weight`, `conv_pw.1.weight`, each
    [out_g, in_g, 1, 1]. With the even channel splits of the mixnet zoo
    this is exactly a grouped conv, whose torch layout is the group-wise
    concat along the OUT axis: [sum(out_g), in_g, 1, 1]. The flax side is
    one nn.Conv(feature_group_count=g) (models/backbone.py _IrBlock).
    """
    groups: Dict[str, List[Tuple[int, Any]]] = {}
    for name in state_dict:
        m = _MIXED_PW_RE.match(name)
        if m:
            groups.setdefault(m.group(1), []).append((int(m.group(2)), name))
    if not groups:
        return state_dict
    out = dict(state_dict)
    for prefix, members in groups.items():
        members.sort()
        arrs = [_to_numpy(out.pop(name)) for _, name in members]
        in_g = {a.shape[1] for a in arrs}
        out_g = {a.shape[0] for a in arrs}
        # a grouped conv needs even splits on BOTH axes: XLA's
        # feature_group_count divides the output channels equally, so an
        # uneven out split would silently pair output channels with the
        # wrong input group
        if len(in_g) != 1 or len(out_g) != 1:
            raise ValueError(
                f"{prefix}: MixedConv groups with uneven channel splits "
                f"{sorted(a.shape for a in arrs)} cannot be expressed as "
                "one grouped conv")
        out[prefix + ".weight"] = np.concatenate(arrs, axis=0)
    return out


def convert_state_dict(state_dict: Dict[str, Any]) -> Dict[str, Dict]:
    """torch state_dict -> {'params': tree, 'batch_stats': tree}.

    Unrecognized entries are collected under '_unmatched' for inspection.
    """
    state_dict = _merge_mixed_pointwise(state_dict)
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}, "_unmatched": {}}
    for name, tensor in state_dict.items():
        arr = _to_numpy(tensor)
        translated = _translate_name(name)
        if translated is None:
            continue
        path, leaf, collection = translated
        _set_in(out[collection], path, leaf, _convert_tensor(arr, leaf))
    return out


def _flatten(tree, prefix=()):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def merge_into_variables(variables: Dict, converted: Dict,
                         strict: bool = False) -> Tuple[Dict, Dict]:
    """Graft converted tensors onto an initialized variables tree.

    Returns (new_variables, report) where report lists 'loaded',
    'missing' (in model but not ckpt) and 'unexpected' (in ckpt but not
    model, or shape mismatches).
    """
    report = {"loaded": [], "missing": [], "unexpected": []}
    new_vars = {}
    for collection in variables:
        model_flat = _flatten(variables[collection])
        ckpt_flat = _flatten(converted.get(collection, {}))
        merged = {}
        for key, val in model_flat.items():
            if key in ckpt_flat and tuple(ckpt_flat[key].shape) == tuple(val.shape):
                merged[key] = np.asarray(ckpt_flat[key], dtype=np.float32)
                report["loaded"].append("/".join(key))
            else:
                if key in ckpt_flat:
                    report["unexpected"].append(
                        "/".join(key) +
                        f" shape {ckpt_flat[key].shape} vs {val.shape}")
                else:
                    report["missing"].append("/".join(key))
                merged[key] = val
        for key in ckpt_flat:
            if key not in model_flat:
                report["unexpected"].append("/".join(key))
        # unflatten
        tree: Dict = {}
        for key, val in merged.items():
            _set_in(tree, key[:-1], key[-1], val)
        new_vars[collection] = tree
    if strict and (report["missing"] or report["unexpected"]):
        raise ValueError(f"checkpoint mismatch: {report}")
    return new_vars, report


def extract_state_dict(checkpoint: Dict[str, Any],
                       use_ema: bool = False) -> Dict[str, Any]:
    """Pick the (EMA) state_dict out of a torch checkpoint container.

    Mirrors timm's load_checkpoint(use_ema=...) semantics used by the
    reference (helpers.py:6, factory.py:46-47): checkpoints may be a raw
    state_dict, or a dict nesting it under 'state_dict'/'model', with EMA
    weights under 'state_dict_ema'/'model_ema'/'ema', or as 'ema_'/'ema.'
    prefixed keys inside a flat state_dict. Falls back to the non-EMA
    weights when use_ema=True but no EMA entry exists.
    """
    state = checkpoint
    if isinstance(state, dict) and not any(
            hasattr(v, "shape") or isinstance(v, np.ndarray)
            for v in state.values()):
        # container dict (all values are sub-dicts / metadata)
        if use_ema:
            for key in ("state_dict_ema", "model_ema", "ema"):
                if key in state and isinstance(state[key], dict):
                    return state[key]
        for key in ("state_dict", "model"):
            if key in state and isinstance(state[key], dict):
                state = state[key]
                break
    if use_ema and isinstance(state, dict):
        ema_items = {
            (k[4:] if k.startswith("ema_") else k[len("ema."):]): v
            for k, v in state.items()
            if k.startswith(("ema_", "ema."))}
        if ema_items:
            return ema_items
    return state


# the one non-tensor global that timm's CheckpointSaver writes (its
# ``args``); anything else a file pickles stays refused
REFERENCE_GLOBALS = (argparse.Namespace,)


def load_reference(path: str) -> Any:
    """Read a reference-format ``.pth`` / ``.pt`` onto the CPU with
    ``torch.load(weights_only=True)``, ``REFERENCE_GLOBALS`` allowed: a
    bare state_dict, a container of one, or timm's training checkpoint
    (``epoch``, ``arch``, ``version``, ``metric``, ``args``,
    ``state_dict``, ``state_dict_ema``). A file that pickles any other
    global raises ``pickle.UnpicklingError``, which names it; the JAX
    package, with ``weights_only=False``, would unpickle it."""
    with torch.serialization.safe_globals(list(REFERENCE_GLOBALS)):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_pytorch_checkpoint(path: str, model: nn.Module,
                            strict: bool = False,
                            use_ema: bool = False) -> Dict[str, list]:
    """Load a reference-format torch checkpoint into ``model`` in place
    (reference load_checkpoint, helpers.py:6; ``use_ema`` as timm's
    switch, factory.py:46-47). Returns the report of
    ``load_jax_variables``: 'loaded', 'missing', 'unexpected'. Without
    ``strict`` the model keeps the tensors the checkpoint lacks, as the
    JAX package's loader does. The file is read by ``load_reference``;
    the JAX function grafts onto a variables tree and returns it with the
    report (``merge_into_variables``)."""
    state = extract_state_dict(load_reference(path), use_ema=use_ema)
    converted = convert_state_dict(state)
    converted.pop("_unmatched")
    return load_jax_variables(model, converted, strict=strict)
