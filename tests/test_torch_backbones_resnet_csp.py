"""ResNet-50 and CSP-ResNet50 / ResNeXt50 (grouped 3 x 3) / Darknet53
against the JAX package's backbones: the cases and tolerances of
tests/test_torch_backbones.py."""

import pytest
from torch_parity_helpers import check_backbone_against_jax


@pytest.mark.parametrize("name", ("resnet50", "cspresnet50",
                                  "cspresnext50", "cspdarknet53"))
def test_backbone_matches_jax(name):
    check_backbone_against_jax(name)
