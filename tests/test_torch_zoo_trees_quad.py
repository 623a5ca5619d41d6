"""The variable trees of the zoo's Quad-FPN Q0-Q2 and TF-SAME D0-D2 entries: each at full width equal to
the JAX model's, every parameter and statistic by flax path and shape
(``torch_parity_helpers.check_zoo_tree``; group "quad_tf_small" of
``ZOO_TREE_GROUPS``)."""
import pytest
from torch_parity_helpers import ZOO_TREE_GROUPS, check_zoo_tree


@pytest.mark.parametrize("name", ZOO_TREE_GROUPS["quad_tf_small"])
def test_zoo_variable_tree_matches_jax(name):
    check_zoo_tree(name)
