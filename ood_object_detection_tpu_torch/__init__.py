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

The serving export (``export_predict``, ``save_artifact``,
``load_artifact``) is reached from the top level lazily, as in the JAX
package: importing the package imports no model code.
"""

__version__ = "0.1.0"

from . import config  # noqa: F401  (framework-free)

# serving export (torch.export artifacts): module, attribute
_LAZY = {
    "export_predict": ("ood_object_detection_tpu_torch.export",
                       "export_predict"),
    "save_artifact": ("ood_object_detection_tpu_torch.export",
                      "save_artifact"),
    "load_artifact": ("ood_object_detection_tpu_torch.export",
                      "load_artifact"),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value        # cache for the next access
    return value


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = ["config", "__version__", *_LAZY]
