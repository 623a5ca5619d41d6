"""The variable trees of the zoo's TF-SAME D3-D7x entries (D6 / D7 with the
summing BiFPN, D7x with P8 and built at 256 px): each at full width equal to
the JAX model's, every parameter and statistic by flax path and shape
(``torch_parity_helpers.check_zoo_tree``; group "tf_large" of
``ZOO_TREE_GROUPS``)."""
import pytest
from torch_parity_helpers import ZOO_TREE_GROUPS, check_zoo_tree


@pytest.mark.parametrize("name", ZOO_TREE_GROUPS["tf_large"])
def test_zoo_variable_tree_matches_jax(name):
    check_zoo_tree(name)
