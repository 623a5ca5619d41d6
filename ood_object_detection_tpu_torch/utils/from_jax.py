"""Load the JAX package's variables into the port's model.

``load_jax_variables(model, variables)`` takes the JAX model's
``{"params": ..., "batch_stats": ...}`` tree (numpy or array-likes) and
loads it into a port module whose submodules carry the reference effdet
names (``backbone.blocks.S.B.conv_dw``, ``fpn.cell.R.fnode.I.combine.
resample.O.conv.conv``, ``class_net.bn_rep.R.L.bn`` ...). It is the inverse
of the JAX package's torch-name converter
(``utils/checkpoint_convert.py:_translate_name`` + ``_convert_tensor``):

  torch path                               flax path
  backbone.conv_stem / bn1                 backbone/conv_stem, bn_stem
  backbone.blocks.S.B.<leaf>               backbone/blocks_S_B/<leaf>
  fpn.resample.L.<leaf>                    fpn/resample_L/<leaf>
  fpn.cell.R.fnode.I.combine.resample.O.*  fpn/cell_R/fnode_I/combine/resample_O/*
  fpn.cell.R.fnode.I.after_combine.conv.*  fpn/cell_R/fnode_I/after_combine_conv/*
  {class,box}_net.conv_rep.R.*             {class,box}_net/conv_rep_R/*
  {class,box}_net.bn_rep.R.L.bn.*          {class,box}_net/bn_rep_R_L/*
  {class,box}_net.predict.*                {class,box}_net/predict/*
  class_net.predict_sep.*                  class_net/predict_sep/*

Layouts: conv ``[kh, kw, in/g, out]`` -> ``[out, in/g, kh, kw]``; dense
``[in, out]`` -> ``[out, in]``; norm ``scale/bias`` -> ``weight/bias`` and
``batch_stats`` ``mean/var`` -> ``running_mean/running_var``.

``load_jax_ema`` carries a JAX train state's ``ema_params`` tree into the
port's EMA copy the same way, and ``load_jax_train_state`` a whole JAX
``TrainState`` (parameters, BatchNorm statistics, EMA, the optax momentum
trace or adam moments, the step) into the port's. For the episodic harness,
``load_jax_projection`` loads a JAX ProjectionNet's parameters
(``dense_{i}/kernel`` -> ``dense.{i}.weight``, and the gate scalars
``dot_mult`` / ``dot_add``) and ``inner_lrs_from_jax`` turns the JAX inner
LRs into the port's dict of tensors.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.heads import HeadBatchNorm

_PATH_RULES = (
    (r"^backbone\.conv_stem$", "backbone.conv_stem"),
    (r"^backbone\.bn1$", "backbone.bn_stem"),
    (r"^backbone\.blocks\.(\d+)\.(\d+)\.", r"backbone.blocks_\1_\2."),
    (r"^fpn\.resample\.(\d+)\.", r"fpn.resample_\1."),
    (r"^fpn\.cell\.(\d+)\.fnode\.(\d+)\.", r"fpn.cell_\1.fnode_\2."),
    (r"\.combine\.resample\.(\d+)\.", r".combine.resample_\1."),
    (r"\.after_combine\.conv\.", ".after_combine_conv."),
    (r"_net\.conv_rep\.(\d+)\.", r"_net.conv_rep_\1."),
    (r"_net\.bn_rep\.(\d+)\.(\d+)\.bn$", r"_net.bn_rep_\1_\2"),
)

_NORMS = (nn.BatchNorm2d, HeadBatchNorm)


def _flax_module_path(module_name: str) -> Tuple[str, ...]:
    path = module_name
    for pattern, repl in _PATH_RULES:
        path = re.sub(pattern, repl, path)
    return tuple(path.split("."))


def _flax_leaf(leaf: str, is_norm: bool) -> Optional[Tuple[str, str]]:
    """(collection, flax leaf) of a torch parameter / buffer name."""
    if leaf == "weight":
        return "params", "scale" if is_norm else "kernel"
    if leaf in ("bias", "edge_weights"):
        return "params", leaf
    if leaf == "running_mean":
        return "batch_stats", "mean"
    if leaf == "running_var":
        return "batch_stats", "var"
    return None                      # num_batches_tracked: not in flax


def _to_torch_layout(arr: np.ndarray, flax_leaf: str) -> np.ndarray:
    if flax_leaf == "kernel" and arr.ndim == 4:
        return np.transpose(arr, (3, 2, 0, 1))
    if flax_leaf == "kernel" and arr.ndim == 2:
        return np.transpose(arr, (1, 0))
    return arr


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()) -> Dict:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _jax_tensors(model: nn.Module, variables: Dict[str, Any],
                 collections: Tuple[str, ...], strict: bool = True
                 ) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """({state_dict name: tensor} of every model tensor that maps into one
    of ``collections``, from the JAX tree; a report of the state_dict names
    'loaded', the model tensors 'missing' a variable and the variables
    'unexpected': not consumed, or of another shape). With ``strict`` a
    missing, unexpected or misshapen variable raises; without, it is only
    reported and the model keeps its tensor."""
    flat = {(coll,) + key: val for coll in collections
            for key, val in _flatten(variables.get(coll, {})).items()}
    tensors_out, used = {}, set()
    report: Dict[str, list] = {"loaded": [], "missing": [], "unexpected": []}
    for module_name, module in model.named_modules():
        is_norm = isinstance(module, _NORMS)
        tensors = list(module.named_parameters(recurse=False)) + \
            list(module.named_buffers(recurse=False))
        for leaf, tensor in tensors:
            name = f"{module_name}.{leaf}" if module_name else leaf
            target = _flax_leaf(leaf, is_norm)
            if target is None or target[0] not in collections:
                continue
            collection, flax_leaf = target
            key = (collection,) + _flax_module_path(module_name) + (flax_leaf,)
            if key not in flat:
                report["missing"].append(f"{name} <- {'/'.join(key)}")
                continue
            used.add(key)
            arr = _to_torch_layout(np.array(flat[key], np.float32), flax_leaf)
            if tuple(arr.shape) != tuple(tensor.shape):
                what = (f"{name}: variable {'/'.join(key)} has shape "
                        f"{arr.shape}, the model {tuple(tensor.shape)}")
                if strict:
                    raise ValueError(what)
                report["unexpected"].append(what)
                continue
            tensors_out[name] = torch.from_numpy(np.ascontiguousarray(arr))
            report["loaded"].append(name)
    report["unexpected"] += sorted("/".join(k) for k in set(flat) - used)
    if strict and (report["missing"] or report["unexpected"]):
        raise ValueError(f"variables do not match the model: missing "
                         f"{report['missing'][:10]}, unexpected "
                         f"{report['unexpected'][:10]}")
    return tensors_out, report


def load_jax_variables(model: nn.Module, variables: Dict[str, Any],
                       strict: bool = True) -> Dict[str, list]:
    """Load ``{"params": tree, "batch_stats": tree}`` into ``model`` in
    place and return the report of ``_jax_tensors``. Strict: raises if a
    model tensor has no variable, a variable is not consumed, or a shape
    disagrees; with ``strict=False`` those are only reported."""
    tensors, report = _jax_tensors(model, variables,
                                   ("params", "batch_stats"), strict)
    state = model.state_dict()
    state.update(tensors)
    model.load_state_dict(state, strict=True)
    return report


def load_jax_ema(ema_params: Dict[str, torch.Tensor], model: nn.Module,
                 jax_ema_params: Dict[str, Any]) -> None:
    """Copy a JAX ``TrainState.ema_params`` tree into the port's EMA copy
    (``train.TrainState.ema_params``: the model's parameter names ->
    tensors), in place, with the same strictness as
    ``load_jax_variables``.

    With ``load_jax_variables`` for the parameters and BatchNorm
    statistics, this starts the port's train state from a JAX one. The
    optimizer state is not carried: a fresh state is zero on both sides
    (optax's momentum trace, torch's momentum buffer), so a port state
    made by ``create_train_state`` matches a fresh JAX state.
    """
    tensors, _ = _jax_tensors(model, {"params": jax_ema_params}, ("params",))
    if sorted(tensors) != sorted(ema_params):
        raise ValueError("the EMA copy does not hold the model's parameters")
    with torch.no_grad():
        for name, value in tensors.items():
            ema_params[name].copy_(value)


def _unflatten(flat: Dict[Tuple[str, ...], Any]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def _optax_states(opt_state: Any, fields: Tuple[str, ...]) -> list:
    """Every optax state (a named tuple) under ``opt_state`` (nested
    tuples, named tuples and dicts: ``chain``, ``multi_transform``) with
    all of ``fields``."""
    if all(f in getattr(opt_state, "_fields", ()) for f in fields):
        return [opt_state]
    if isinstance(opt_state, dict):
        children = opt_state.values()
    elif isinstance(opt_state, tuple):
        children = opt_state
    else:
        children = [getattr(opt_state, "inner_state", None)]
    return [s for c in children if c is not None
            for s in _optax_states(c, fields)]


def _merged(trees: list) -> Dict:
    """One parameter tree from per-group trees whose other groups' leaves
    are optax's ``MaskedNode`` (an empty tuple)."""
    flat = {}
    for tree in trees:
        flat.update({k: v for k, v in _flatten(tree).items()
                     if not isinstance(v, tuple)})
    return _unflatten(flat)


def load_jax_train_state(state, jax_state: Any) -> None:
    """Start the port's ``train.TrainState`` from a JAX one, in place: the
    parameters and BatchNorm statistics (``load_jax_variables``), the EMA
    copy (``load_jax_ema``), the step, and the optimizer's state: optax's
    momentum trace as torch SGD's ``momentum_buffer`` (the same
    recurrence, ``t = g + m t``), or adam's ``mu`` / ``nu`` / ``count`` as
    torch Adam's ``exp_avg`` / ``exp_avg_sq`` / ``step``. ``jax_state``: a
    JAX ``TrainState`` or a dict of its fields."""
    def get(name):
        return jax_state[name] if isinstance(jax_state, dict) else \
            getattr(jax_state, name)
    model, tx = state.model, state.optimizer
    load_jax_variables(model, {"params": get("params"),
                               "batch_stats": get("batch_stats")})
    if state.ema_params is not None:
        load_jax_ema(state.ema_params, model, get("ema_params"))
    named = dict(model.named_parameters())
    traces = _optax_states(get("opt_state"), ("trace",))
    adams = _optax_states(get("opt_state"), ("mu", "nu", "count"))
    if isinstance(tx, torch.optim.SGD) and traces:
        trace, _ = _jax_tensors(model, {"params": _merged(
            [t.trace for t in traces])}, ("params",))
        for name, p in named.items():
            tx.state[p]["momentum_buffer"] = trace[name].to(p.device)
    elif isinstance(tx, torch.optim.Adam) and adams:
        mu, _ = _jax_tensors(model, {"params": _merged(
            [a.mu for a in adams])}, ("params",))
        nu, _ = _jax_tensors(model, {"params": _merged(
            [a.nu for a in adams])}, ("params",))
        count = float(np.asarray(adams[0].count))
        for name, p in named.items():
            tx.state[p].update(step=torch.tensor(count),
                               exp_avg=mu[name].to(p.device),
                               exp_avg_sq=nu[name].to(p.device))
    else:
        raise ValueError(f"the JAX optimizer state does not match the "
                         f"port's {type(tx).__name__}")
    state.step = int(np.asarray(get("step")))


def load_jax_projection(proj_net: nn.Module, proj_params: Dict[str, Any]
                        ) -> None:
    """Load a JAX ProjectionNet's ``{"dense_i": {"kernel": [in, out]},
    "dot_mult": (), "dot_add": ()}`` into ``proj_net`` in place. Strict:
    every port tensor must have its variable, and every variable a
    tensor."""
    tensors = {}
    for name, p in proj_net.named_parameters():
        parts = name.split(".")
        if parts[0] == "dense":
            arr = np.array(proj_params[f"dense_{parts[1]}"]["kernel"],
                           np.float32).T
        else:
            arr = np.array(proj_params[name], np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: variable shape {arr.shape}, the "
                             f"model {tuple(p.shape)}")
        tensors[name] = torch.tensor(arr)
    if len(tensors) != len(proj_params):
        raise ValueError(f"variables {sorted(proj_params)} do not match "
                         f"the ProjectionNet {sorted(tensors)}")
    with torch.no_grad():
        for name, p in proj_net.named_parameters():
            p.copy_(tensors[name])


def inner_lrs_from_jax(inner_lrs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX inner-LR tree (``init_inner_lrs``) as f32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in inner_lrs.items()}
