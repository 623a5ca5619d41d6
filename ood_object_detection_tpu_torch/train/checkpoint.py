"""Train checkpoints with true resume (port of
``ood_object_detection_tpu.train.checkpoint``): torch files in place of
orbax.

A checkpoint of a ``TrainState`` holds the model's parameters and
BatchNorm statistics, the EMA copy, the optimizer's state (momentum
buffers or adam moments, each group's learning rate) and the step; a
checkpoint of nested dicts of tensors (the meta driver's ``meta_params``)
holds those tensors. Each step is one file, ``step_<N>.pt`` in the
directory, written under a temporary name and moved into place with
``os.replace``: a run killed mid-save leaves the newest whole step, as
orbax does. Only the newest ``keep`` steps stay. As orbax's manager, a
save at a step not above the latest saved one is skipped. Files are read
with ``torch.load(weights_only=True)``; the learning-rate schedules,
being functions, are not saved, and a restore keeps the optimizer's own.
The port reads no orbax directory.

In a data-parallel run (a ``mesh`` of more than one process) every rank
calls ``save`` with the same state: rank 0 writes and decides, its answer
is broadcast, and no rank returns before the file is in place. A
restore reads the same file on every rank. (JAX's orbax save is itself a
collective, so there too every rank must make the same decision.)
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .train_state import TrainState

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _tree(state: Any) -> Any:
    """The tensors and numbers of ``state`` as a tree torch.save writes
    and ``torch.load(weights_only=True)`` reads."""
    if isinstance(state, TrainState):
        opt = state.optimizer.state_dict()
        opt["param_groups"] = [
            {k: v for k, v in g.items() if k != "lr_schedule"}
            for g in opt["param_groups"]]
        return {"step": int(state.step), "model": state.model.state_dict(),
                "optimizer": opt, "ema": state.ema_params}
    if isinstance(state, nn.Module):
        return state.state_dict()
    if isinstance(state, dict):
        return {k: _tree(v) for k, v in state.items()}
    return state.detach() if isinstance(state, torch.Tensor) else state


def _checked(like: Any, tree: Any, path: str = "") -> Any:
    """``tree`` after checking it has the keys and tensor shapes of
    ``like``; its tensors on ``like``'s devices and dtypes."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(like) != set(tree):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"checkpoint {path or 'root'}: keys {got} do "
                             f"not match {sorted(like)}")
        return {k: _checked(like[k], tree[k], f"{path}/{k}") for k in like}
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != like.shape:
            got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else \
                type(tree)
            raise ValueError(f"checkpoint {path}: {got} where the state "
                             f"has shape {tuple(like.shape)}")
        return tree.to(device=like.device, dtype=like.dtype)
    return tree


@torch.no_grad()
def _copy_into(like: Any, tree: Any) -> None:
    """Copy the checked ``tree`` into the tensors of ``like`` in place."""
    if isinstance(like, dict):
        for k in like:
            _copy_into(like[k], tree[k])
    elif isinstance(like, torch.Tensor):
        like.copy_(tree)


def _restore_into(state_like: Any, tree: Any) -> Any:
    if isinstance(state_like, TrainState):
        state_like.model.load_state_dict(tree["model"])
        opt = state_like.optimizer
        schedules = [g.get("lr_schedule") for g in opt.param_groups]
        opt.load_state_dict(tree["optimizer"])
        for group, schedule in zip(opt.param_groups, schedules):
            group["lr_schedule"] = schedule
        if state_like.ema_params is not None:
            _copy_into(state_like.ema_params,
                       _checked(state_like.ema_params, tree["ema"], "ema"))
        state_like.step = int(tree["step"])
        return state_like
    if isinstance(state_like, nn.Module):
        state_like.load_state_dict(tree)
        return state_like
    _copy_into(state_like, _checked(state_like, tree))
    return state_like


def _write(path: str, payload: Any) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """save(step, state), restore(state_like) -> state, in ``directory``,
    keeping the newest ``keep`` steps; with a ``mesh`` of more than one
    process, rank 0 writes (see the module's docstring)."""

    def __init__(self, directory: str, keep: int = 5, mesh=None):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self) -> List[int]:
        """The whole steps in the directory, oldest first (a temporary
        file of an unfinished save is not one)."""
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any,
             metrics: Optional[Dict[str, float]] = None) -> bool:
        """Write ``state`` (a ``TrainState``, a module, or nested dicts of
        tensors) as step ``step`` with its ``metrics``; False, and nothing
        written, when a step at or above ``step`` is saved already."""
        if self.mesh is None:
            return self._save(step, state, metrics)
        from ..parallel.mesh import process_gather
        wrote = self._save(step, state, metrics) if self.mesh.rank == 0 \
            else None
        return bool(process_gather(wrote, self.mesh)[0])

    def _save(self, step: int, state: Any,
              metrics: Optional[Dict[str, float]]) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        _write(self._path(step), {"step": int(step), "state": _tree(state),
                                  "metrics": dict(metrics or {})})
        for old in self.all_steps()[:-self.keep]:
            os.remove(self._path(old))
        return True

    def _load(self, step: Optional[int]) -> Dict:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load step ``step`` (the latest when None) into ``state_like``
        in place and return it."""
        return _restore_into(state_like, self._load(step)["state"])

    def metrics(self, step: Optional[int] = None) -> Dict[str, float]:
        """The metrics saved with step ``step`` (the latest when None)."""
        return self._load(step)["metrics"]

    def wait(self):
        """Saves are synchronous: nothing to wait for."""

    def close(self):
        """Nothing is held open between calls."""


def save_variables(path: str, variables: Any) -> None:
    """One-shot save of model variables (a state_dict, or nested dicts of
    tensors), written under a temporary name and moved into place."""
    _write(os.path.abspath(path), _tree(variables))


def restore_variables(path: str, variables_like: Any) -> Any:
    """One-shot restore against a template of the same keys and shapes:
    returns the loaded tree on the template's devices; raises ValueError
    when a key or a shape differs."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    return _checked(_tree(variables_like), tree)
