"""Head outputs of ``efficientdet_es``, ``mobiledetv3_large`` and
``tf_efficientdet_lite0`` against the JAX package's: the cases and
tolerances of tests/test_torch_zoo_heads.py."""
import pytest
from torch_parity_helpers import check_zoo_heads


@pytest.mark.parametrize("name", ["efficientdet_es", "mobiledetv3_large",
                                  "tf_efficientdet_lite0"])
def test_zoo_heads_match_jax(name):
    check_zoo_heads(name)
