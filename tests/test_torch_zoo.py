"""Every entry of the model zoo in the port (mirrors tests/test_models.py:
the zoo backbones, ``test_cspresdet50_model_forward`` and
``test_zoo_variant_full_forward``).

- Every one of the 37 entries builds at full width and runs a forward on
  the CPU at 128 px (``tf_efficientdet_d7x`` at 256, whose P8 is under a
  pixel at 128 in both packages), with one BiFPN cell and one head repeat
  (the trees below are built at full depth): one output a pyramid level,
  anchors x classes / anchors x 4 channels.
- Every entry holds the JAX model's variable tree exactly, every
  parameter and statistic by flax path and shape
  (``torch_parity_helpers.check_zoo_tree``), in the five
  tests/test_torch_zoo_trees*.py files (``ZOO_TREE_GROUPS``).
- ``create_backbone`` accepts what the JAX one accepts: other
  ``backbone_args`` (``efficientdet_w0``'s ``feature_location``) are
  unused, ResNet and CSP take ``remat_stages`` / ``drop_path_rate`` and
  ignore them; an unknown name raises NotImplementedError listing the
  JAX package's full set.
- A reference-named MixNet checkpoint (timm's ``conv_pw.0`` / ``.1``
  per-group pointwise convs, ``conv_dw.{i}`` mixed depthwise convs) loads
  strictly through ``utils/checkpoint_convert`` (its
  ``_merge_mixed_pointwise``) and gives the model it came from.
"""
import re

import pytest
import torch
from torch_parity_helpers import ZOO_TREE_GROUPS, zoo_size

from ood_object_detection_tpu.models.backbone import (
    create_backbone as jax_create_backbone)
from ood_object_detection_tpu_torch.config import (
    efficientdet_model_param_dict, get_efficientdet_config)
from ood_object_detection_tpu_torch.models.backbone import create_backbone
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.utils.checkpoint_convert import (
    load_pytorch_checkpoint)

def test_the_tree_files_cover_the_zoo():
    held = sum(ZOO_TREE_GROUPS.values(), ())
    assert sorted(held) == sorted(efficientdet_model_param_dict)


@pytest.mark.parametrize("name", sorted(efficientdet_model_param_dict))
def test_zoo_entry_builds_and_runs(name):
    size = zoo_size(name)
    cfg = get_efficientdet_config(name, num_classes=3).replace(
        image_size=(size, size), fpn_cell_repeats=1, box_class_repeats=1)
    model = EfficientDet(cfg).eval()
    with torch.no_grad():
        cls, box = model(torch.zeros(1, size, size, 3))
    a = cfg.num_anchors_per_location
    assert len(cls) == len(box) == cfg.num_levels
    for lvl, (c, b) in enumerate(zip(cls, box)):
        side = size >> (cfg.min_level + lvl)
        assert tuple(c.shape) == (1, side, side, a * 3)
        assert tuple(b.shape) == (1, side, side, a * 4)


def _names(module):
    return {n: tuple(t.shape) for n, t in module.state_dict().items()}


def test_create_backbone_accepts_what_jax_accepts():
    plain, info = create_backbone("efficientnet_b0")
    swallowed, info2 = create_backbone("efficientnet_b0",
                                       feature_location="depthwise")
    assert info == info2 and _names(plain) == _names(swallowed)
    for name in ("resnet50", "cspresnet50"):
        base, base_info = create_backbone(name)
        knobs, knobs_info = create_backbone(name, remat_stages=3,
                                            drop_path_rate=0.2)
        assert base_info == knobs_info and _names(base) == _names(knobs)
        assert not any(hasattr(m, "drop_path_rate") for m in knobs.modules())
        jax_create_backbone(name, remat_stages=3, drop_path_rate=0.2)
    with pytest.raises(NotImplementedError) as ours:
        create_backbone("not_a_backbone")
    with pytest.raises(NotImplementedError) as theirs:
        jax_create_backbone("not_a_backbone")
    listed = [re.search(r"available: (\[.*\])", str(e.value)).group(1)
              for e in (ours, theirs)]
    assert listed[0] == listed[1]


def _reference_state(model):
    """The model's state_dict under timm's MixNet names: each grouped
    pointwise conv split into ``conv_pw.{g}`` / ``conv_pwl.{g}`` per
    group (out-channel blocks), each mixed depthwise conv
    ``conv_dw.{i}``."""
    groups = {f"{n}.weight": m.groups for n, m in model.named_modules()
              if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (1, 1)
              and m.groups > 1}
    out = {}
    for name, t in model.state_dict().items():
        if name in groups:
            prefix = name[:-len(".weight")]
            for g, part in enumerate(t.chunk(groups[name], dim=0)):
                out[f"{prefix}.{g}.weight"] = part.clone()
        else:
            out[re.sub(r"\.conv_dw\.conv_dw_(\d+)\.", r".conv_dw.\1.",
                       name)] = t
    return out


def test_reference_named_mixnet_checkpoint_loads(tmp_path):
    cfg = get_efficientdet_config("mixdet_m", num_classes=4).replace(
        image_size=(128, 128), fpn_cell_repeats=1, box_class_repeats=1)
    source = EfficientDet(cfg)
    source.init_weights(torch.Generator().manual_seed(3))
    state = _reference_state(source)
    assert any(re.search(r"conv_pw\.1\.weight$", n) for n in state)
    assert any(re.search(r"conv_dw\.2\.weight$", n) for n in state)
    path = str(tmp_path / "mixdet_m.pth")
    torch.save(state, path)
    target = EfficientDet(cfg)
    report = load_pytorch_checkpoint(path, target, strict=True)
    assert not report["missing"] and not report["unexpected"]
    for (n, a), b in zip(source.state_dict().items(),
                         target.state_dict().values()):
        assert torch.equal(a, b), n
