"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port, which runs on the CPU with its kernels' plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

# the tier-1 run uses several xdist workers: keep each one's torch small
torch.set_num_threads(2)


def random_variables(init_fn, seed):
    """The variable tree that ``init_fn(key)`` (a flax ``init``) would
    make, filled from numpy instead: kernels at fan-in scale, BatchNorm
    statistics and affines away from the identity, positive BiFPN edge
    weights, small biases and means."""
    shapes = jax.eval_shape(init_fn, jax.random.key(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, s.shape)
        elif leaf == "edge_weights":
            v = np.abs(rng.normal(1, 0.2, s.shape))
        else:                                          # bias, mean
            v = rng.normal(0, 0.1, s.shape)
        return v.astype(np.float32)

    return {c: jax.tree_util.tree_map_with_path(draw, shapes[c])
            for c in shapes}


def head_outputs(feat_sizes, min_level, max_level, num_classes, rng,
                 batch=2, num_anchors=9, cls_mean=-6.0, ties=False):
    """Per-level NHWC class / box outputs [B, H, W, A*C] / [B, H, W, A*4]
    as f32 numpy. ``ties``: logits on a coarse grid, so bf16 values (and
    packed keys) repeat often."""
    cls_out, box_out = [], []
    for lvl in range(min_level, max_level + 1):
        h, w = feat_sizes[lvl]
        c = rng.normal(cls_mean, 1.5, (batch, h, w, num_anchors * num_classes))
        if ties:    # (+ 0.0 turns -0.0 into 0.0: the key orders -0 < +0)
            c = np.round(c * 4) / 4 + 0.0
        cls_out.append(c.astype(np.float32))
        box_out.append(rng.normal(0, 0.3, (batch, h, w, num_anchors * 4))
                       .astype(np.float32))
    return cls_out, box_out


def to_torch(arrays, dtype=torch.float32):
    """numpy f32 arrays -> torch tensors, rounded to ``dtype`` as jax's
    ``astype`` rounds (both round to nearest even)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for a in arrays]


def to_numpy(t):
    return t.detach().to(torch.float32).cpu().numpy() \
        if t.dtype == torch.bfloat16 else t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# backbones (tests/test_torch_backbones*.py)
# ---------------------------------------------------------------------------

# tests/test_models.py:38-46, 151-160
BACKBONE_CHANNELS = {
    "efficientnet_es": [48, 144, 192], "resnet50": [512, 1024, 2048],
    "mixnet_m": [40, 120, 200], "mixnet_l": [56, 160, 264],
    "cspresnet50": [256, 512, 1024], "cspresnext50": [512, 1024, 2048],
    "cspdarknet53": [256, 512, 1024]}


class _Holder(nn.Module):
    """The backbone under the ``backbone`` name, as the model holds it, so
    that from_jax's path rules apply."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _port(name, variables):
    """The port's backbone ``name`` with the JAX backbone's ``variables``,
    loaded strictly."""
    from ood_object_detection_tpu_torch.models.backbone import \
        create_backbone
    from ood_object_detection_tpu_torch.utils.from_jax import \
        load_jax_variables
    holder = _Holder(create_backbone(name)[0])
    report = load_jax_variables(holder, {
        c: {"backbone": v} for c, v in variables.items()})
    assert not report["missing"] and not report["unexpected"]
    return holder.to(memory_format=torch.channels_last)


def _assert_stats_close(model, ref, before, momentum=0.01):
    """Every running statistic of ``model`` against ``ref``'s (buffer name
    -> tensor) after one train-mode forward from ``before``, to 5e-6 plus
    a share of the batch's moments (E[x^2], recovered from ``model``'s
    statistics): the mean to momentum x 5e-3 x sqrt(E[x^2]), the variance
    to momentum x 5e-3 x E[x^2]; and every one of them moved."""
    buffers = dict(model.named_buffers())
    for n, var in buffers.items():
        if not n.endswith("running_var"):
            continue
        p = n[:-len("running_var")]
        mean = buffers[p + "running_mean"]
        keep = 1.0 - momentum
        second = (var - keep * before[n]) / momentum + (
            (mean - keep * before[p + "running_mean"]) / momentum) ** 2
        share = momentum * 5e-3
        for stat, got, tol in (
                ("running_mean", mean, 5e-6 + share * second.sqrt()),
                ("running_var", var, 5e-6 + share * second)):
            diff = (got - ref[p + stat]).abs()
            assert bool((diff <= tol).all()), (
                f"{p}{stat}: {float(diff.max())} beyond its tolerance")
            assert not torch.equal(got, before[p + stat]), p + stat


def check_backbone_against_jax(name, img=128):
    """The port's backbone ``name`` against the JAX package's on 2 seeded
    images of ``img`` px (tests/test_torch_backbones.py's docstring): the
    JAX variables load strictly, feature_info equal, eval-mode f32
    features to rtol = atol = 1e-5, train-mode running statistics by
    ``_assert_stats_close``."""
    from ood_object_detection_tpu.models.backbone import \
        create_backbone as jax_create_backbone
    from ood_object_detection_tpu_torch.models.backbone import \
        create_backbone
    jax_module, jax_info = jax_create_backbone(name)
    variables = random_variables(
        lambda k: jax_module.init(k, jnp.zeros((1, img, img, 3)), False),
        seed=3)
    images = np.random.default_rng(4).normal(
        0, 1, (2, img, img, 3)).astype(np.float32)

    @jax.jit
    def run(v, x):
        feats = jax_module.apply(v, x, False)
        _, new = jax_module.apply(v, x, True, mutable=["batch_stats"])
        return feats, new["batch_stats"]

    feats, new_stats = run(variables, images)
    _, info = create_backbone(name)
    assert info == jax_info
    if name in BACKBONE_CHANNELS:
        assert [f["num_chs"] for f in info] == BACKBONE_CHANNELS[name]

    model = _port(name, variables)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    before = {n: b.clone() for n, b in model.named_buffers()}
    with torch.no_grad():
        ours = model.backbone.eval()(x)
        for lvl, (o, r) in enumerate(zip(ours, feats)):
            np.testing.assert_allclose(
                o.permute(0, 2, 3, 1).numpy(), np.asarray(r), rtol=1e-5,
                atol=1e-5, err_msg=f"{name} feature {lvl}")
        model.backbone.train()(x)
    ref = dict(_port(name, {"params": variables["params"],
                            "batch_stats": jax.device_get(new_stats)}
                     ).named_buffers())
    _assert_stats_close(model, ref, before)


# ---------------------------------------------------------------------------
# the model zoo (tests/test_torch_zoo*.py)
# ---------------------------------------------------------------------------

# every zoo entry, in the groups that tests/test_torch_zoo_trees*.py hold
# (five files of about equal cost, so that xdist's loadfile spreads them)
ZOO_TREE_GROUPS = {
    "resnet_csp_mixnet": (
        "resdet50", "cspresdet50", "cspresdext50", "cspresdext50pan",
        "cspdarkdet53", "mixdet_m", "mixdet_l"),
    "mobile_edge_lite": (
        "mobiledetv2_110d", "mobiledetv2_120d", "mobiledetv3_large",
        "efficientdet_w0", "efficientdet_es", "efficientdet_em",
        "efficientdet_lite0", "tf_efficientdet_lite0",
        "tf_efficientdet_lite1", "tf_efficientdet_lite2",
        "tf_efficientdet_lite3", "tf_efficientdet_lite4"),
    "efficientdet": (
        "efficientdet_d0", "efficientdet_d1", "efficientdet_d2",
        "efficientdet_d3", "efficientdet_d4", "efficientdet_d5"),
    "quad_tf_small": (
        "efficientdet_q0", "efficientdet_q1", "efficientdet_q2",
        "tf_efficientdet_d0", "tf_efficientdet_d1", "tf_efficientdet_d2"),
    "tf_large": (
        "tf_efficientdet_d3", "tf_efficientdet_d4", "tf_efficientdet_d5",
        "tf_efficientdet_d6", "tf_efficientdet_d7", "tf_efficientdet_d7x"),
}


def zoo_size(name):
    """The image size a zoo entry is built at on the CPU: 128 px, and 256
    for tf_efficientdet_d7x, whose P8 is under a pixel at 128 in both
    packages."""
    return 256 if name == "tf_efficientdet_d7x" else 128


def check_zoo_tree(name):
    """The port's EfficientDet of zoo entry ``name`` (full width, at
    ``zoo_size``) holds exactly the JAX model's variables: every parameter
    and BatchNorm statistic by flax path and shape, the JAX side from
    ``jax.eval_shape(model.init, ...)`` (no compile). Both sides keep at
    most two BiFPN cells and two head repeats: the first cell reads the
    backbone's widths and every later one repeats the second, and each
    head repeat is one conv and a BatchNorm a level, so two hold every
    name pattern; tracing the full depth takes the JAX side twice as
    long."""
    from ood_object_detection_tpu.config import get_efficientdet_config \
        as jax_cfg
    from ood_object_detection_tpu.models.efficientdet import EfficientDet \
        as JaxDet
    from ood_object_detection_tpu_torch.config import \
        get_efficientdet_config
    from ood_object_detection_tpu_torch.models.efficientdet import \
        EfficientDet
    from ood_object_detection_tpu_torch.utils.from_jax import \
        flax_variable_shapes
    size = zoo_size(name)

    def cut(cfg):
        return cfg.replace(image_size=(size, size),
                           fpn_cell_repeats=min(cfg.fpn_cell_repeats, 2),
                           box_class_repeats=min(cfg.box_class_repeats, 2))

    cfg = cut(jax_cfg(name))
    shapes = jax.eval_shape(lambda: JaxDet(cfg).init(
        jax.random.key(0), jnp.zeros((1, size, size, 3)), False))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    with torch.device("meta"):        # shapes only: no weights drawn
        model = EfficientDet(cut(get_efficientdet_config(name)))
    got = flax_variable_shapes(model)
    assert sorted(set(want) - set(got)) == [], "missing in the port"
    assert sorted(set(got) - set(want)) == [], "not in the JAX tree"
    assert {k: v for k, v in got.items() if want[k] != v} == {}


def check_zoo_heads(name, img=128):
    """Zoo entry ``name`` at ``img`` px, 4 classes, one BiFPN cell and one
    head repeat: the JAX model's variables (filled from numpy) load
    strictly into the port, and on 2 seeded images every class and box
    output agrees, f32 to rtol = atol = 1e-5, bf16 to rtol 2^-7 / atol
    2^-6 (tests/test_torch_zoo_heads.py's docstring)."""
    from ood_object_detection_tpu.config import get_efficientdet_config \
        as jax_cfg
    from ood_object_detection_tpu.models.efficientdet import EfficientDet \
        as JaxDet
    from ood_object_detection_tpu_torch.config import \
        get_efficientdet_config
    from ood_object_detection_tpu_torch.models.efficientdet import \
        EfficientDet
    from ood_object_detection_tpu_torch.utils.from_jax import \
        load_jax_variables
    tiny = dict(num_classes=4, image_size=(img, img), fpn_cell_repeats=1,
                box_class_repeats=1)
    variables = random_variables(
        lambda k: JaxDet(jax_cfg(name, **tiny)).init(
            k, jnp.zeros((1, img, img, 3)), False), seed=5)
    images = np.random.default_rng(6).uniform(
        -2, 2, (2, img, img, 3)).astype(np.float32)
    for dtype, rtol, atol in (("float32", 1e-5, 1e-5),
                              ("bfloat16", 2 ** -7, 2 ** -6)):
        jmodel = JaxDet(jax_cfg(name, compute_dtype=dtype, **tiny))
        jcls, jbox = jax.jit(lambda v, x: jmodel.apply(v, x, False))(
            variables, images)
        model = EfficientDet(get_efficientdet_config(
            name, compute_dtype=dtype, **tiny))
        load_jax_variables(model, variables)
        model = model.to(memory_format=torch.channels_last).eval()
        with torch.no_grad():
            cls, box = model(torch.from_numpy(images))
        for what, ours, ref in (("class", cls, jcls), ("box", box, jbox)):
            assert len(ours) == len(ref) == 5
            for lvl, (o, r) in enumerate(zip(ours, ref)):
                assert o.dtype == getattr(torch, dtype)
                np.testing.assert_allclose(
                    to_numpy(o), np.asarray(r, np.float32), rtol=rtol,
                    atol=atol, err_msg=f"{name} {dtype} {what} level {lvl}")
