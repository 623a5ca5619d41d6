"""The variable trees of the zoo's MobileNet, w0, edge and lite entries: each at full width equal to
the JAX model's, every parameter and statistic by flax path and shape
(``torch_parity_helpers.check_zoo_tree``; group "mobile_edge_lite" of
``ZOO_TREE_GROUPS``)."""
import pytest
from torch_parity_helpers import ZOO_TREE_GROUPS, check_zoo_tree


@pytest.mark.parametrize("name", ZOO_TREE_GROUPS["mobile_edge_lite"])
def test_zoo_variable_tree_matches_jax(name):
    check_zoo_tree(name)
