"""Shared set-up of the meta-harness parity tests (tests/test_torch_meta_*.py).

The JAX side is the JAX package on the CPU at the size of its own meta
tests (tests/test_separate_head.py): EfficientDet-D0 at 128 px, one class,
one BiFPN cell, one head repeat, f32; 2 supports, 3 queries + 1 zero
image, 3 projection crops. Its variables are random (numpy, seed 0), the
ProjectionNet's come from its flax init, and the episode from the JAX
``EpisodicDataset`` over a ``SyntheticEpisodeSource``. The port loads
the same variables (``utils.from_jax``) and runs the same episode
arrays on the CPU.

Two choices keep the data from being degenerate, and both sides share
them:
- 3 projection crops, not 2: with two champions the phase-A validity test
  ``avg_init > mean(avg_init)`` compares two numbers that are equal in
  exact arithmetic (the champions' similarity matrix is symmetric), so its
  outcome is each framework's f32 rounding;
- the running statistics are calibrated on the episodes' images
  (``calibrate_batch_stats``): with random running statistics the frozen
  trunk's pyramid barely depends on the image (differences of 1e-3 to
  1e-7), every crop gives the same champion embedding and no champion is
  valid; with trunk BatchNorm in batch-statistic mode instead, the
  statistics of 3 crops' 1x1 maps make the pyramid ill-conditioned (the
  two frameworks' f32 pyramids differ by up to 9e-4).
"""
import random as pyrandom
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data.episodic import (EpisodicDataset,
                                                    SyntheticEpisodeSource)
from ood_object_detection_tpu.meta import MetaConfig as JaxMetaConfig
from ood_object_detection_tpu.meta import ProjectionNet as JaxProjectionNet
from ood_object_detection_tpu.meta.projection import POS_DIM as JAX_POS_DIM
from ood_object_detection_tpu.models import EfficientDet as JaxDet
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.meta import MetaConfig, ProjectionNet
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.utils.from_jax import (
    _flax_module_path, load_jax_projection, load_jax_variables)

IMG = 128
META_KW = dict(num_sup=2, num_qry=3, num_zero_images=1, img_size=IMG,
               qry_img_size=IMG, meta_batch_size=2)
MODEL_KW = dict(num_classes=1, image_size=(IMG, IMG), fpn_cell_repeats=1,
                box_class_repeats=1, max_detection_points=1000)
HOST_KEYS = ("task_cats", "val_iter")


def configs(separate_head=False, **meta_kw):
    """(JAX meta config, JAX model config, port meta config, port model
    config) of the tiny set-up."""
    kw = {**META_KW, "separate_head": separate_head, **meta_kw}
    jmc = jax_cfg("efficientdet_d0", separate_head=separate_head).replace(
        **MODEL_KW)
    tmc = get_efficientdet_config(
        "efficientdet_d0", separate_head=separate_head).replace(**MODEL_KW)
    return JaxMetaConfig(**kw), jmc, MetaConfig(**kw), tmc


def jax_model(jmc, seed=0):
    """(JAX EfficientDet, random variables)."""
    model = JaxDet(jmc)
    variables = random_variables(
        lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), training=False),
        seed)
    return model, variables


def jax_projection(jmeta, seed=1):
    """(JAX ProjectionNet, its params with the gate scalars)."""
    net = JaxProjectionNet(fpn_channels=64, width=jmeta.proj_size,
                           depth=jmeta.proj_depth)
    params = dict(net.init(jax.random.key(seed),
                           jnp.zeros((1, 64 + JAX_POS_DIM)))["params"])
    params["dot_mult"] = jnp.float32(jmeta.dot_mult)
    params["dot_add"] = jnp.float32(jmeta.dot_add)
    return net, params


def port_model(tmc, variables, proj_params, tmeta):
    """The port's EfficientDet and ProjectionNet holding the JAX values."""
    model = EfficientDet(tmc)
    load_jax_variables(model, variables)
    proj = ProjectionNet(64, tmeta.proj_size, tmeta.proj_depth)
    load_jax_projection(proj, proj_params)
    return model.eval(), proj


def jax_episodes(jmeta, jmc, seed=0xD15EA5E, count=1):
    """(projection level sizes, ``count`` non-validation JAX episodes)."""
    src = SyntheticEpisodeSource(num_cats=4, img_hw=(IMG, IMG))
    cats = [1, 2, 3, 4]
    dataset = EpisodicDataset(src.support_source(cats), src, jmc, jmeta,
                              train_cats=cats[:3], val_cats=cats[3:],
                              val_freq=10 ** 9)
    state = pyrandom.getstate()
    pyrandom.seed(seed)
    episodes = []
    try:
        for ep in dataset:
            if not ep["val_iter"]:
                episodes.append(ep)
            if len(episodes) == count:
                break
    finally:
        pyrandom.setstate(state)
    return dataset.builder.proj_level_sizes, episodes


def jax_arrays(ep):
    """The episode's device arrays (a jit argument, not a constant)."""
    return {k: v for k, v in ep.items() if k not in HOST_KEYS}


def torch_batch(ep):
    """The JAX episode as the port's batch (CPU tensors)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in ep.items()
            if k not in HOST_KEYS}


def port_leaf_to_jax(tree, tree_name, name):
    """The JAX value of port meta parameter ``name`` of ``tree_name``
    ('class_net', 'proj', 'inner_lrs') in ``tree`` (a JAX tree of the same
    structure as ``meta_params``), in the port's layout, as numpy."""
    parts = name.split(".")
    if tree_name == "class_net":
        node = tree["class_net"]
        for key in _flax_module_path("class_net." + ".".join(parts[:-1]))[1:]:
            node = node[key]
        is_norm = ".bn." in name
        leaf = {"weight": "scale" if is_norm else "kernel",
                "bias": "bias"}[parts[-1]]
        arr = np.asarray(node[leaf])
        return arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr
    if tree_name == "proj":
        if parts[0] == "dense":
            return np.asarray(tree["proj"][f"dense_{parts[1]}"]["kernel"]).T
        return np.asarray(tree["proj"][name])
    return np.asarray(tree["inner_lrs"][name])


def assert_meta_close(port, jax_tree, rtol, atol, what=""):
    """Every tensor of a port meta-parameter tree (dicts of tensors by
    name) against its JAX counterpart. Returns the largest absolute error
    and the largest error relative to its leaf's largest magnitude."""
    worst_abs = worst_rel = 0.0
    for tree_name, leaves in port.items():
        for name, value in leaves.items():
            want = port_leaf_to_jax(jax_tree, tree_name, name)
            got = value.detach().numpy()
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                       err_msg=f"{what} {tree_name} {name}")
            err = float(np.abs(got - want).max()) if got.size else 0.0
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel,
                            err / max(float(np.abs(want).max()), 1e-30))
    return worst_abs, worst_rel


def leaf_meta_params(model, proj, jax_lrs):
    """The port's meta parameters as fresh leaves (copies of the model's
    and the ProjectionNet's tensors, and the JAX inner LRs)."""
    from ood_object_detection_tpu_torch.utils.from_jax import (
        inner_lrs_from_jax)
    return {
        "class_net": {n: p.detach().clone().requires_grad_()
                      for n, p in model.class_net.named_parameters()},
        "proj": {n: p.detach().clone().requires_grad_()
                 for n, p in proj.named_parameters()},
        "inner_lrs": {k: v.requires_grad_()
                      for k, v in inner_lrs_from_jax(jax_lrs).items()},
    }


def calibrate_batch_stats(model, variables, images):
    """``variables`` with every running statistic set to the batch
    statistic of ``images`` in one training-mode pass (each layer's update
    ``ra' = 0.99 ra + 0.01 batch``, solved for ``batch``; variances
    clipped at 0), so that frozen BatchNorm normalises such images to
    about unit scale."""
    _, new = jax.jit(lambda v, x: model.apply(
        v, x, training=True, mutable=["batch_stats"]))(variables, images)

    def solve(path, n, o):
        batch = (np.asarray(n, np.float64) - 0.99 * np.asarray(o, np.float64)
                 ) / 0.01
        if path[-1].key == "var":
            batch = np.maximum(batch, 0.0)
        return batch.astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(
        solve, new["batch_stats"], variables["batch_stats"])
    return {**variables, "batch_stats": stats}


def optax_moments(opt_state, names):
    """{(moment, tree, port name): numpy} of the adam moments / SGD traces
    in a JAX meta optimizer's state (``optax.chain(clip,
    multi_transform)``), over the port names ``{tree: [name, ...]}``
    that each group owns."""
    out = {}
    for inner in opt_state[1].inner_states.values():
        if not inner.inner_state:                 # set_to_zero: no state
            continue
        first = inner.inner_state[0]
        for moment in ("mu", "nu", "trace"):
            tree = getattr(first, moment, None)
            if tree is None:
                continue
            for t, leaves in names.items():
                for n in leaves:
                    value = port_leaf_to_jax(tree, t, n)
                    if value.shape != (0,):          # not an optax.MaskedNode
                        out[moment, t, n] = value
    return out


def setup(separate_head=False, count=1, **meta_kw):
    """Both sides of the tiny set-up (running statistics calibrated on the
    episodes' images) and ``count`` episodes."""
    jmeta, jmc, tmeta, tmc = configs(separate_head, **meta_kw)
    jmodel, variables = jax_model(jmc)
    jproj, proj_params = jax_projection(jmeta)
    lsz, episodes = jax_episodes(jmeta, jmc, count=count)
    ep = episodes[0]
    variables = calibrate_batch_stats(jmodel, variables, jnp.concatenate(
        [e[k] for e in episodes
         for k in ("supp_images", "qry_images", "proj_images")]))
    model, proj = port_model(tmc, variables, proj_params, tmeta)
    return SimpleNamespace(jmeta=jmeta, jmc=jmc, tmeta=tmeta, tmc=tmc,
                           jmodel=jmodel, variables=variables, jproj=jproj,
                           proj_params=proj_params, model=model, proj=proj,
                           lsz=lsz, ep=ep, batch=torch_batch(ep),
                           episodes=episodes,
                           batches=[torch_batch(e) for e in episodes])
