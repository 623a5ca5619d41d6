"""Model factory: zoo name -> EfficientDet, or its predict / train bench,
on a device.

Port of ``ood_object_detection_tpu.factory`` (``bench_task`` '', 'predict'
and 'train'), with its parameters in its order and ``device`` last. The
weights are drawn from a ``torch.Generator`` seeded with ``seed`` (the
JAX package's initialisers, focal prior bias on the class predict conv);
trained weights come in from a reference-format ``.pth`` / ``.pt`` at
``checkpoint_path`` (``utils.checkpoint_convert``), from the published
release weights with ``pretrained=True`` (``utils.pretrained``: fetched
once into a local cache), or through ``utils.from_jax.load_jax_variables``.
An orbax directory is not read.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .bench import DetBenchPredict, DetBenchTrain
from .config.model_config import ModelConfig, get_efficientdet_config
from .models.efficientdet import EfficientDet


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device to build on: ``None`` means the CUDA card, and raises
    when there is none; the port never drops to the CPU unless the caller
    names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def create_model(model_name: str = "tf_efficientdet_d1",
                 bench_task: str = "",
                 num_classes: Optional[int] = None,
                 pretrained: bool = False,
                 checkpoint_path: str = "",
                 checkpoint_ema: bool = False,
                 seed: int = 0,
                 init_batch_size: int = 1,
                 ood_method: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 **config_overrides):
    """Build a model by zoo name (optionally wrapped in a predict or train
    bench) on ``device``: the CUDA card when None (raises without one), or the
    device named. ``config_overrides`` go into the model config;
    ``checkpoint_path`` names a reference-format ``.pth`` / ``.pt`` to load
    over the seeded weights (its EMA weights with ``checkpoint_ema``). With
    ``pretrained=True`` and no ``checkpoint_path``, the published release
    weights of ``model_name`` are taken from the cache, fetched there first
    if they are not in it (``utils.pretrained.download_checkpoint``; the
    reference's load_pretrained, helpers.py:14-23). ``init_batch_size`` is
    the JAX package's dummy batch for ``init`` and changes nothing here: a
    torch module is built without one."""
    config = get_efficientdet_config(model_name)
    if num_classes is not None:
        config = config.replace(num_classes=num_classes)
    if config_overrides:
        config = config.replace(**config_overrides)
    if pretrained and not checkpoint_path:
        from .utils.pretrained import download_checkpoint
        checkpoint_path = download_checkpoint(model_name)
    return create_model_from_config(
        config, bench_task=bench_task, checkpoint_path=checkpoint_path,
        checkpoint_ema=checkpoint_ema, seed=seed,
        init_batch_size=init_batch_size, ood_method=ood_method,
        device=device)


def create_model_from_config(config: ModelConfig, bench_task: str = "",
                             checkpoint_path: str = "",
                             checkpoint_ema: bool = False,
                             seed: int = 0,
                             init_batch_size: int = 1,
                             ood_method: Optional[str] = None,
                             device: Optional[Union[str, torch.device]] = None):
    """EfficientDet (``bench_task=''``), DetBenchPredict (``'predict'``)
    or DetBenchTrain (``'train'``) with seeded weights, channels_last, on
    ``device``; the train bench in train mode, the others in eval mode.
    ``init_batch_size`` is accepted for the JAX signature and unused."""
    if bench_task not in ("", "predict", "train"):
        raise ValueError(f"bench_task {bench_task!r} is not one of '', "
                         "'predict', 'train'")
    if checkpoint_path and not checkpoint_path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{checkpoint_path!r}: only .pth / .pt files are read (a "
            "reference-format checkpoint or the port's own variables file, "
            "train.checkpoint.save_variables); the port reads no orbax "
            "directory")
    device = resolve_device(device)
    model = EfficientDet(config)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint_path:
        from .utils.checkpoint_convert import load_pytorch_checkpoint
        load_pytorch_checkpoint(checkpoint_path, model,
                                use_ema=checkpoint_ema)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    if bench_task == "predict":
        return DetBenchPredict(model, ood_method=ood_method).eval()
    if bench_task == "train":
        return DetBenchTrain(model).to(device).train()
    return model
