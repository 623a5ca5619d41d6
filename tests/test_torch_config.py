"""The port's config copies equal the JAX package's, field by field."""
import dataclasses

import pytest

from ood_object_detection_tpu.config import fpn_config as jax_fpn
from ood_object_detection_tpu.config import model_config as jax_mc
from ood_object_detection_tpu_torch.config import fpn_config as pt_fpn
from ood_object_detection_tpu_torch.config import model_config as pt_mc


@pytest.mark.parametrize("name", sorted(jax_mc.efficientdet_model_param_dict))
def test_zoo_entry_equal(name):
    assert sorted(pt_mc.efficientdet_model_param_dict) == \
        sorted(jax_mc.efficientdet_model_param_dict)
    assert dataclasses.asdict(pt_mc.get_efficientdet_config(name)) == \
        dataclasses.asdict(jax_mc.get_efficientdet_config(name))


def test_default_config_equal():
    assert dataclasses.asdict(pt_mc.default_detection_model_configs()) == \
        dataclasses.asdict(jax_mc.default_detection_model_configs())


@pytest.mark.parametrize("fpn_name", sorted(jax_fpn._FPN_BUILDERS))
@pytest.mark.parametrize("levels", [(3, 7), (2, 6), (3, 8)])
def test_fpn_graph_equal(fpn_name, levels):
    assert sorted(pt_fpn._FPN_BUILDERS) == sorted(jax_fpn._FPN_BUILDERS)
    lo, hi = levels
    ours = pt_fpn.get_fpn_config(fpn_name, min_level=lo, max_level=hi)
    ref = jax_fpn.get_fpn_config(fpn_name, min_level=lo, max_level=hi)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", [f"efficientnet_b{i}" for i in range(8)]
                         + ["tf_efficientnet_b0"])
def test_backbone_feature_info_equal(name):
    """Channels and reductions of the P3-P5 taps of every EfficientNet."""
    from ood_object_detection_tpu.models.backbone import (
        create_backbone as jax_create_backbone,
    )
    from ood_object_detection_tpu_torch.models.backbone import create_backbone
    assert create_backbone(name)[1] == list(jax_create_backbone(name)[1])
