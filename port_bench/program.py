"""What the benchmark takes from the program: the system under test built
from a configuration file, with the benchmark's weights loaded into it."""
from __future__ import annotations

from typing import Dict

import torch


def _frozen(v):
    return tuple(_frozen(x) for x in v) if isinstance(v, list) else v


def build(config: Dict, task: str, state: Dict[str, torch.Tensor], device):
    """The port's ``create_model(<zoo name>, bench_task=task, ...)`` with
    every model field of the configuration file, then ``state`` loaded."""
    from ood_object_detection_tpu_torch import factory

    fields = {k: _frozen(v) for k, v in config["model"].items()
              if k != "name"}
    bench = factory.create_model(config["zoo_name"], bench_task=task,
                                 ood_method=config.get("ood_method"),
                                 device=device, **fields)
    bench.model.load_state_dict(state)
    return bench
