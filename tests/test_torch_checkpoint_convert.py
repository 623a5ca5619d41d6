"""Reference-format effdet checkpoints into the port vs the JAX package's
converter: the copied name rules and ``extract_state_dict`` give equal
results, and a synthesized reference-named state_dict of a full-width D0,
saved as a ``.pth`` and loaded by the port, gives the port model the same
tensors, bit for bit, as JAX ``convert_state_dict`` followed by
``utils.from_jax.load_jax_variables``; a timm training checkpoint (an
``argparse.Namespace`` beside the weights and their EMA copy) loads as the
JAX package loads it, and a file that pickles any other class is
refused."""
import argparse
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ood_object_detection_tpu.config import get_efficientdet_config
from ood_object_detection_tpu_torch.examples import deploy_infer
from ood_object_detection_tpu.models import EfficientDet as JaxEfficientDet
from ood_object_detection_tpu.utils import checkpoint_convert as jconvert
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.utils import checkpoint_convert as convert
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

from test_checkpoint_convert import _inverse_name

IMG = 128


@pytest.fixture(scope="module")
def reference_state_dict():
    """A reference-named state_dict covering every variable of the JAX D0
    (90 classes, full width) at 128 px, from numpy, with the expected JAX
    tree."""
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=90).replace(
        image_size=(IMG, IMG))
    model = JaxEfficientDet(cfg)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), training=False),
        jax.random.key(0))
    rng = np.random.default_rng(0)
    state = {}
    flat = jax.tree_util.tree_flatten_with_path(
        {k: shapes[k] for k in ("params", "batch_stats")})[0]
    for pathkeys, val in flat:
        keys = tuple(str(getattr(k, "key", k)) for k in pathkeys)
        arr = rng.normal(0, 1, val.shape).astype(np.float32)
        if keys[-1] == "var":
            arr = np.abs(arr) + 0.5
        name = _inverse_name(keys[1:-1], keys[-1], keys[0])
        if keys[-1] == "kernel" and arr.ndim == 4:
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif keys[-1] == "kernel" and arr.ndim == 2:
            arr = arr.T
        state[name] = torch.from_numpy(np.ascontiguousarray(arr))
    state["backbone.bn1.num_batches_tracked"] = torch.tensor(5)
    return state


def _port_model():
    return create_model("efficientdet_d0", num_classes=90,
                        image_size=(IMG, IMG), device="cpu")


def test_name_rules_match_jax(reference_state_dict):
    for name in list(reference_state_dict) + [
            "module.class_net.predict.conv_pw.bias",
            "model.backbone.blocks.0.0.conv_dw.1.weight"]:
        assert convert._translate_name(name) == jconvert._translate_name(name)
    mixed = {f"backbone.blocks.1.0.conv_pw.{i}.weight": np.full(
        (4, 2, 1, 1), i, np.float32) for i in range(2)}
    ours, ref = (m.convert_state_dict(mixed)["params"]["backbone"]
                 ["blocks_1_0"]["conv_pw"]["kernel"]
                 for m in (convert, jconvert))
    np.testing.assert_array_equal(ours, ref)


def test_pth_loads_like_convert_then_from_jax(reference_state_dict, tmp_path):
    path = tmp_path / "d0.pth"
    torch.save({"state_dict": reference_state_dict, "epoch": 3}, path)
    ours = _port_model()
    report = convert.load_pytorch_checkpoint(str(path), ours, strict=True)
    assert not report["missing"] and not report["unexpected"]

    via_jax = _port_model()
    tree = jconvert.convert_state_dict(reference_state_dict)
    load_jax_variables(via_jax, {k: tree[k] for k in ("params",
                                                      "batch_stats")})
    got, want = ours.state_dict(), via_jax.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # and the reference names are the port's own module names
    assert all(torch.equal(got[k], v) for k, v in reference_state_dict.items()
               if k in got and k.endswith(("weight", "bias")))


def test_extract_state_dict_ema_variants_match_jax():
    w, w_ema = np.ones(3, np.float32), np.full(3, 2.0, np.float32)
    for ckpt in ({"state_dict": {"a": w}, "state_dict_ema": {"a": w_ema},
                  "epoch": 7},
                 {"model": {"a": w}, "model_ema": {"a": w_ema}},
                 {"a": w, "ema_a": w_ema, "ema.b": w_ema},
                 {"state_dict": {"a": w}}, {"a": w}):
        for use_ema in (False, True):
            got = convert.extract_state_dict(ckpt, use_ema=use_ema)
            want = jconvert.extract_state_dict(ckpt, use_ema=use_ema)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_ema_weights_and_a_partial_checkpoint(tmp_path):
    """use_ema picks the EMA copy; without strict a checkpoint holding one
    tensor loads it, reports the rest missing and keeps them."""
    bias = "class_net.predict.conv_pw.bias"
    model = _port_model()
    plain = {bias: torch.zeros(810)}
    ema = {bias: torch.full((810,), 5.0), "extra.weight": torch.ones(2)}
    path = tmp_path / "ema.pth"
    torch.save({"state_dict": plain, "state_dict_ema": ema}, path)
    before = model.backbone.conv_stem.weight.clone()
    report = convert.load_pytorch_checkpoint(str(path), model, use_ema=True)
    assert report["loaded"] == [bias]
    assert "extra/kernel" in "".join(report["unexpected"])
    assert len(report["missing"]) > 100
    assert torch.equal(model.class_net.predict_bias(), ema[bias])
    assert torch.equal(model.backbone.conv_stem.weight, before)
    convert.load_pytorch_checkpoint(str(path), model)
    assert torch.equal(model.class_net.predict_bias(), plain[bias])
    with pytest.raises(ValueError, match="missing"):
        convert.load_pytorch_checkpoint(str(path), model, strict=True)


def test_create_model_reads_pth_and_refuses_orbax(reference_state_dict,
                                                  tmp_path):
    path = tmp_path / "d0.pt"
    torch.save(reference_state_dict, path)
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=90, image_size=(IMG, IMG), device="cpu",
                         checkpoint_path=str(path))
    assert torch.equal(bench.model.class_net.predict_bias(),
                       reference_state_dict["class_net.predict.conv_pw.bias"])
    orbax = tmp_path / "orbax_dir"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="reads no orbax directory"):
        create_model("efficientdet_d0", device="cpu",
                     checkpoint_path=str(orbax))


class _Pickled:
    """A class of this module: no checkpoint may unpickle it."""


def _timm_container(state, ema, **extra):
    """What timm's CheckpointSaver writes (its ``metric`` a Python
    float)."""
    return {"epoch": 12, "arch": "efficientdet_d0", "version": 2,
            "metric": 0.3125,
            "args": argparse.Namespace(model="efficientdet_d0", lr=0.09,
                                       model_ema=True),
            "state_dict": state, "state_dict_ema": ema, **extra}


def test_timm_checkpoint_loads_like_the_jax_package(reference_state_dict,
                                                    tmp_path):
    """A timm training checkpoint loads in the port to the JAX package's
    tensors, bit for bit, with and without ``use_ema``; through
    ``create_model(checkpoint_path=..., checkpoint_ema=True)`` and the
    deploy CLI's ``load_checkpoint`` too."""
    ema = {k: v + 0.5 if v.is_floating_point() else v
           for k, v in reference_state_dict.items()}
    path = str(tmp_path / "model_best.pth")
    torch.save(_timm_container(reference_state_dict, ema), path)
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=90).replace(
        image_size=(IMG, IMG))
    shapes = jax.eval_shape(
        lambda k: JaxEfficientDet(cfg).init(
            k, jnp.zeros((1, IMG, IMG, 3)), training=False),
        jax.random.key(0))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   {k: shapes[k] for k in ("params",
                                                           "batch_stats")})
    bias = "class_net.predict.conv_pw.bias"
    for use_ema, want_state in ((False, reference_state_dict), (True, ema)):
        variables, jreport = jconvert.load_pytorch_checkpoint(
            path, zeros, use_ema=use_ema)
        assert not jreport["missing"] and not jreport["unexpected"]
        via_jax = _port_model()
        load_jax_variables(via_jax, variables, strict=True)
        ours = _port_model()
        report = convert.load_pytorch_checkpoint(path, ours, strict=True,
                                                 use_ema=use_ema)
        assert len(report["loaded"]) == len(jreport["loaded"])
        got, want = ours.state_dict(), via_jax.state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (use_ema, k)
        assert torch.equal(ours.class_net.predict_bias(), want_state[bias])
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=90, image_size=(IMG, IMG), device="cpu",
                         checkpoint_path=path, checkpoint_ema=True)
    assert torch.equal(bench.model.class_net.predict_bias(), ema[bias])
    model = _port_model()
    assert deploy_infer.load_checkpoint(model, path) == "reference"
    assert torch.equal(model.class_net.predict_bias(),
                       reference_state_dict[bias])


def test_a_checkpoint_pickling_another_class_is_refused(tmp_path):
    """Only ``argparse.Namespace`` is let in beside the tensors: a file
    that pickles any other class raises and names it, through the
    converter, ``create_model`` and the deploy CLI alike."""
    state = {"class_net.predict.conv_pw.bias": torch.zeros(810)}
    path = str(tmp_path / "other.pth")
    torch.save(_timm_container(state, state, extra=_Pickled()), path)
    for load in (lambda: convert.load_reference(path),
                 lambda: convert.load_pytorch_checkpoint(path, _port_model()),
                 lambda: create_model("efficientdet_d0", num_classes=90,
                                      image_size=(IMG, IMG), device="cpu",
                                      checkpoint_path=path),
                 lambda: deploy_infer.load_checkpoint(_port_model(), path)):
        with pytest.raises(pickle.UnpicklingError, match="_Pickled"):
            load()
