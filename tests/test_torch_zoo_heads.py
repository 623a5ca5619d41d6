"""Head outputs of zoo entries of the new families against the JAX
package's (mirrors tests/test_models.py::test_cspresdet50_model_forward
and ``test_zoo_variant_full_forward``): ``cspresdet50`` (CSP backbone,
leaky-ReLU, SiLU heads, plain 3 x 3 head convs, bilinear upsampling),
``mixdet_m`` (mixed depthwise kernels, grouped pointwise convs),
``efficientdet_es`` (edge backbone, plain head convs), ``mobiledetv3_large``
(hard-swish, SE from the expanded width) and ``tf_efficientdet_lite0``
(TF-SAME padding, ReLU, no SE); at 128 px, 4 classes, one BiFPN cell and
one head repeat, 2 seeded images. The first two here, the other three in
tests/test_torch_zoo_heads_mobile.py (``torch_parity_helpers.
check_zoo_heads``).

The JAX variables (filled from numpy) load strictly into the port
(``utils/from_jax``); every class and box output of every level agrees:
f32 to rtol = atol = 1e-5; bf16 to rtol 2^-7 (one bf16 step) and atol
2^-6 (measured: at most 0.0098, on 14 of efficientdet_es's 18,432 P3
class outputs, the rest within 2^-7; the port rounds at its own places,
as ROADMAP's "bf16 rounds at other places" holds for D0).
"""
import pytest
from torch_parity_helpers import check_zoo_heads


@pytest.mark.parametrize("name", ["cspresdet50", "mixdet_m"])
def test_zoo_heads_match_jax(name):
    check_zoo_heads(name)
