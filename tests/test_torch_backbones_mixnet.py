"""MixNet s / m / l against the JAX package's backbones (mixed depthwise
kernels over uneven splits, grouped pointwise convs): the cases and
tolerances of tests/test_torch_backbones.py."""

import pytest
from torch_parity_helpers import check_backbone_against_jax


@pytest.mark.parametrize("name", ("mixnet_s", "mixnet_m", "mixnet_l"))
def test_backbone_matches_jax(name):
    check_backbone_against_jax(name)
