"""Weight loading from the JAX package's variables, reference checkpoints
and the published weights; the bench's device timer; the drivers'
tracing / timing / logging helpers.

The JAX package's ``utils`` names, from the port's own modules, but
``enable_xla_dump``: it asks XLA to dump its compiled programs, and the
port compiles nothing through XLA.
"""
from .benchmark import device_time, throughput
from .checkpoint_convert import (
    convert_state_dict,
    load_pytorch_checkpoint,
    merge_into_variables,
)
from .pretrained import (
    PRETRAINED_URLS,
    download_checkpoint,
    load_pretrained,
)
from .profiling import MetricLogger, StepTimer, annotate, trace
