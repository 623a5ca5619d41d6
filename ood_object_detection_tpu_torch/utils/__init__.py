"""Weight loading from the JAX package's variables and reference
checkpoints, and the drivers' tracing / timing / logging helpers."""
from .profiling import MetricLogger, StepTimer, annotate, trace
