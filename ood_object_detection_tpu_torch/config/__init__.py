from .fpn_config import (FpnGraph, FpnNode, bifpn_graph, get_fpn_config,
                         pan_graph, qufpn_graph)
from .model_config import (
    ModelConfig,
    default_detection_model_configs,
    efficientdet_model_param_dict,
    get_efficientdet_config,
)
from .train_config import TrainConfig, default_detection_train_config

__all__ = [
    "ModelConfig", "default_detection_model_configs",
    "efficientdet_model_param_dict", "get_efficientdet_config",
    "TrainConfig", "default_detection_train_config", "FpnGraph",
    "FpnNode", "get_fpn_config", "bifpn_graph", "pan_graph", "qufpn_graph",
]
