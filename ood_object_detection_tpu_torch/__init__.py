"""ood_object_detection_tpu_torch: the PyTorch / CUDA port of
ood_object_detection_tpu.

The JAX package beside it is the reference: every module here keeps the
JAX package's public layouts (NHWC head outputs, [B, max_det, 6]
detections) so the tests in tests/test_torch_*.py compare like with like.
The port imports torch and numpy only, never jax or the JAX package.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the hand-written kernels (ops/cuda_nms.py,
ops/cuda_reduce.py, ops/cuda_labeler.py) launch for CUDA tensors and use
their plain PyTorch versions for CPU tensors.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401  (framework-free)
