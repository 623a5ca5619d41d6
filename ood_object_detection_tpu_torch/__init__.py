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

The top-level names are the JAX package's (the reference's package
surface, effdet/__init__.py): ``create_model``, ``DetBenchPredict`` /
``DetBenchTrain`` / ``unwrap_bench``, ``EfficientDet``,
``create_dataset`` / ``create_loader`` / ``create_parser``,
``create_evaluator`` and the evaluator classes, the config getters,
``load_pytorch_checkpoint`` and the serving export (``export_predict``,
``save_artifact``, ``load_artifact``), and the packages ``config`` and
``ops``. Each resolves lazily from the port's own module on first use
(PEP 562), so importing the package imports no model, ops or export
code. (The JAX package imports ``ops`` eagerly, as it loads no jax at
module scope; the port's ``ops`` imports the kernels' wrappers.)
"""

__version__ = "0.1.0"

from . import config  # noqa: F401  (framework-free)

# name: (module, attribute), or (module, None) for a module itself
_LAZY = {
    "ops": ("ood_object_detection_tpu_torch.ops", None),
    # model / bench / factory
    "EfficientDet": ("ood_object_detection_tpu_torch.models",
                     "EfficientDet"),
    "DetBenchPredict": ("ood_object_detection_tpu_torch.bench",
                        "DetBenchPredict"),
    "DetBenchTrain": ("ood_object_detection_tpu_torch.bench",
                      "DetBenchTrain"),
    "unwrap_bench": ("ood_object_detection_tpu_torch.bench", "unwrap_bench"),
    "create_model": ("ood_object_detection_tpu_torch.factory",
                     "create_model"),
    "create_model_from_config": ("ood_object_detection_tpu_torch.factory",
                                 "create_model_from_config"),
    # data
    "create_dataset": ("ood_object_detection_tpu_torch.data",
                       "create_dataset"),
    "create_loader": ("ood_object_detection_tpu_torch.data", "create_loader"),
    "create_parser": ("ood_object_detection_tpu_torch.data", "create_parser"),
    "DetectionDataset": ("ood_object_detection_tpu_torch.data",
                         "DetectionDataset"),
    "SkipSubset": ("ood_object_detection_tpu_torch.data", "SkipSubset"),
    # evaluation
    "create_evaluator": ("ood_object_detection_tpu_torch.evaluation",
                         "create_evaluator"),
    "CocoEvaluator": ("ood_object_detection_tpu_torch.evaluation",
                      "CocoEvaluator"),
    "PascalEvaluator": ("ood_object_detection_tpu_torch.evaluation",
                        "PascalEvaluator"),
    "OpenImagesEvaluator": ("ood_object_detection_tpu_torch.evaluation",
                            "OpenImagesEvaluator"),
    # config
    "get_efficientdet_config": ("ood_object_detection_tpu_torch.config",
                                "get_efficientdet_config"),
    "default_detection_model_configs": (
        "ood_object_detection_tpu_torch.config",
        "default_detection_model_configs"),
    # reference-format checkpoints (the reference's load_checkpoint)
    "load_pytorch_checkpoint": (
        "ood_object_detection_tpu_torch.utils.checkpoint_convert",
        "load_pytorch_checkpoint"),
    # serving export (torch.export artifacts)
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
    module = importlib.import_module(target[0])
    value = module if target[1] is None else getattr(module, target[1])
    globals()[name] = value        # cache for the next access
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = ["config", "__version__", *_LAZY]
