"""``utils.from_jax.load_jax_variables`` is the inverse of the JAX
package's torch-name converter: a random port state_dict goes through
``convert_state_dict`` + ``merge_into_variables(strict=True)`` into the
JAX model's variable tree and comes back equal, tensor for tensor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.utils.checkpoint_convert import (
    convert_state_dict,
    merge_into_variables,
)
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables


def _random_state(model, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: (torch.randn(v.shape, generator=gen) if v.is_floating_point()
                else v.clone())
            for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", ["efficientdet_d0", "tf_efficientdet_d0"])
def test_round_trip_through_jax_converter(name):
    cfg = get_efficientdet_config(name, num_classes=90).replace(
        image_size=(128, 128))
    state = _random_state(EfficientDet(cfg), seed=1)

    jcfg = jax_cfg(name, num_classes=90).replace(image_size=(128, 128))
    shapes = jax.eval_shape(
        lambda k: JaxDet(jcfg).init(k, jnp.zeros((1, 128, 128, 3)), False),
        jax.random.key(0))
    template = {c: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes[c])
        for c in ("params", "batch_stats")}
    converted = convert_state_dict({k: v.numpy() for k, v in state.items()})
    assert not converted["_unmatched"]
    variables, report = merge_into_variables(template, converted, strict=True)
    assert len(report["loaded"]) > 400

    model = EfficientDet(cfg)
    load_jax_variables(model, variables)
    back = model.state_dict()
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        torch.testing.assert_close(back[key], value, rtol=0, atol=0,
                                   msg=key)


def test_missing_and_extra_variables_raise():
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=4).replace(
        image_size=(128, 128))
    model = EfficientDet(cfg)
    converted = convert_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()})
    variables = {c: converted[c] for c in ("params", "batch_stats")}
    load_jax_variables(model, variables)               # complete: loads
    del variables["params"]["box_net"]["predict"]["conv_pw"]["bias"]
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(model, variables)
    variables["params"]["box_net"]["predict"]["conv_pw"]["bias"] = \
        np.zeros(36, np.float32)
    variables["params"]["extra"] = {"kernel": np.zeros((1, 1, 1, 1))}
    with pytest.raises(ValueError, match="unexpected"):
        load_jax_variables(model, variables)
