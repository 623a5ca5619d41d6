"""Model factory: zoo name -> EfficientDet, or its predict / train bench,
on a device.

Port of ``ood_object_detection_tpu.factory`` (``bench_task`` '', 'predict'
and 'train'). The weights are drawn from a ``torch.Generator`` seeded with
``seed`` (the JAX package's initialisers, focal prior bias on the class
predict conv); trained weights come in from a reference-format ``.pth`` /
``.pt`` at ``checkpoint_path`` (``utils.checkpoint_convert``) or through
``utils.from_jax.load_jax_variables``. An orbax directory is not read, and
nothing is downloaded.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .bench import DetBenchPredict, DetBenchTrain
from .config.model_config import ModelConfig, get_efficientdet_config
from .models.efficientdet import EfficientDet
from .utils.checkpoint_convert import load_pytorch_checkpoint


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
                 seed: int = 0,
                 ood_method: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 checkpoint_path: str = "",
                 checkpoint_ema: bool = False,
                 **config_overrides):
    """Build a model by zoo name (optionally wrapped in a predict or train
    bench) on ``device``: the CUDA card when None (raises without one), or the
    device named. ``config_overrides`` go into the model config;
    ``checkpoint_path`` names a reference-format ``.pth`` / ``.pt`` to load
    over the seeded weights (its EMA weights with ``checkpoint_ema``)."""
    config = get_efficientdet_config(model_name)
    if num_classes is not None:
        config = config.replace(num_classes=num_classes)
    if config_overrides:
        config = config.replace(**config_overrides)
    return create_model_from_config(config, bench_task=bench_task, seed=seed,
                                    ood_method=ood_method, device=device,
                                    checkpoint_path=checkpoint_path,
                                    checkpoint_ema=checkpoint_ema)


def create_model_from_config(config: ModelConfig, bench_task: str = "",
                             seed: int = 0,
                             ood_method: Optional[str] = None,
                             device: Optional[Union[str, torch.device]] = None,
                             checkpoint_path: str = "",
                             checkpoint_ema: bool = False):
    """EfficientDet (``bench_task=''``), DetBenchPredict (``'predict'``)
    or DetBenchTrain (``'train'``) with seeded weights, channels_last, on
    ``device``; the train bench in train mode, the others in eval mode."""
    if bench_task not in ("", "predict", "train"):
        raise ValueError(f"bench_task {bench_task!r} is not one of '', "
                         "'predict', 'train'")
    if checkpoint_path and not checkpoint_path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            f"{checkpoint_path!r}: only reference-format .pth / .pt "
            "checkpoints are read; the port reads no orbax directory, and "
            "its own train checkpoints are ROADMAP Queue 1 item 5")
    device = resolve_device(device)
    model = EfficientDet(config)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint_path:
        load_pytorch_checkpoint(checkpoint_path, model,
                                use_ema=checkpoint_ema)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    if bench_task == "predict":
        return DetBenchPredict(model, ood_method=ood_method).eval()
    if bench_task == "train":
        return DetBenchTrain(model).to(device).train()
    return model
