"""Weight loading from the JAX package's variables, reference checkpoints
and the published weights; the bench's device timer; the drivers'
tracing / timing / logging helpers.

The JAX package's ``utils`` names, from the port's own modules, but
``enable_xla_dump``: it asks XLA to dump its compiled programs, and the
port compiles nothing through XLA. The names of ``benchmark`` and
``checkpoint_convert`` load on first use: those modules import the models,
whose modules import ``profiling`` from this package.
"""
from .pretrained import (
    PRETRAINED_URLS,
    download_checkpoint,
    load_pretrained,
)
from .profiling import MetricLogger, StepTimer, annotate, span, trace

_LAZY = {"device_time": "benchmark", "throughput": "benchmark",
         "convert_state_dict": "checkpoint_convert",
         "load_pytorch_checkpoint": "checkpoint_convert",
         "merge_into_variables": "checkpoint_convert"}


def __getattr__(name):
    import importlib
    if name in _LAZY.values():
        return importlib.import_module(f".{name}", __name__)
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY) | set(_LAZY.values()))
