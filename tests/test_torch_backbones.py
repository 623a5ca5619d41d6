"""The port's backbones against the JAX package's, one case a family
member: here EfficientNet edge (es / em) and lite (torch and TF-SAME
padding), MobileNetV2 (110d: fixed stem, fixed first / last stage depth)
and V3 (hard-swish, SE from the expanded width, hard-sigmoid gate,
divisor 8); MixNet s / m / l (mixed depthwise kernels, grouped pointwise
convs) in tests/test_torch_backbones_mixnet.py; ResNet-50 and
CSP-ResNet50 / ResNeXt50 (grouped 3 x 3) / Darknet53 in
tests/test_torch_backbones_resnet_csp.py (three files, so that xdist's
loadfile spreads them; ``torch_parity_helpers.check_backbone_against_jax``
runs each case).

The JAX backbone's variables, filled from numpy (``random_variables``),
load strictly into the port through ``utils/from_jax`` (no missing,
unexpected or misshapen leaf); the same seeded images (2 x 128 x 128)
go through both:
- eval mode, f32: every emitted feature to rtol 1e-5 / atol 1e-5;
- train mode: every BatchNorm running statistic after one forward (the
  JAX side's new statistics carried into a second port model and compared
  buffer for buffer), to 5e-6 plus a share of the batch's moments: the
  running mean to 0.01 x 5e-3 x sqrt(E[x^2]), the running variance to
  0.01 x 5e-3 x E[x^2] (momentum 0.01; E[x^2] of the batch, recovered from
  the port's statistics). Measured: the EfficientNet, MobileNetV3 and
  MixNet families within 1e-6 of each other; in ResNet-50, MobileNetV2 and
  the CSP nets up to 3e-6 absolute, and in the CSP nets' last stage (4 x 4
  maps at 128 px, 32 values a channel, normalised by their own moments in
  train mode) the batch variances differ by up to 0.22 % of E[x^2]: the
  frameworks sum the convs and the moments in other orders, and E[x^2] -
  E[x]^2 over so few values carries that through
  (tests/test_torch_train_step.py measures 1.8e-6 on D0's);
- the emitted channels and reductions (``feature_info``) equal JAX's, and
  those of ``test_models.py::test_mixnet_and_csp_feature_channels``.
Mirrors tests/test_models.py:38-70, 151-199 and tests/test_mixnet_parity.py.
"""
import pytest
from torch_parity_helpers import check_backbone_against_jax


@pytest.mark.parametrize("name", ("efficientnet_es", "efficientnet_em",
                                  "efficientnet_lite0",
                                  "tf_efficientnet_lite0", "mobilenetv2_110d",
                                  "mobilenetv3_large_100"))
def test_backbone_matches_jax(name):
    check_backbone_against_jax(name)
