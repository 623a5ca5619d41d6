"""The benchmark entry point (``run_bench``) and its timer
(``utils.benchmark``) against the JAX package's root ``bench.py``, on the
CPU with the plain kernel versions.

- Row names: the default run's three rows are BENCH_r05.json's strings
  letter for letter; the meta and loader rows read as the JAX bench
  formats them.
- ``device_time`` calls ``fn`` warmup + repeats x iters times and raises
  for the card where there is none.
- The predict builder against the JAX bench's ``full`` graph
  (``bench.py:111-116``) on the same weights (a tiny D0 at 128 px, 90
  classes, numpy-seeded, three classes raised over the score floor):
  per_anchor and exact top-k, with and without the letterbox. In f32 the
  detections' classes are equal and boxes, scores and OOD within
  tests/test_torch_model.py's f32 slice bars. In bf16 (the bench's dtype)
  the letterboxed image is within tests/test_torch_preproc.py's bf16 bar
  (JAX resamples in bf16, the port in f32) and the two frameworks' bf16 head outputs differ by
  up to two bf16 steps (tests/test_torch_model.py), which moves
  candidates across the top-k and NMS boundaries, so bf16 is held as
  that test holds it: the builder's head outputs within 2^-7 of JAX's,
  and its detections equal (classes bit for bit) to the JAX
  post-process run on those head outputs.
- The train builder's first step against JAX ``make_train_step`` from
  the same JAX state, at tests/test_torch_train_bench.py's bf16 bars.
- ``main()`` in each mode on the CPU (``BENCH_DEVICE=cpu``), batch 1, one
  iteration, the meta episode at 128 / 128; without ``BENCH_DEVICE`` and
  without a card it exits with a message.
- The loader row: the native core here where it loads, PIL when
  ``native_decode.available`` says it does not.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables, to_numpy

from ood_object_detection_tpu.bench import DetBenchPredict as JaxBench
from ood_object_detection_tpu.config import (
    default_detection_train_config as jax_train_config)
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data.device_preproc import (
    batched_letterbox_normalize as jax_letterbox)
from ood_object_detection_tpu.meta import MetaConfig as JaxMetaConfig
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.ops.post_process import (
    generate_detections as jax_generate_detections)
from ood_object_detection_tpu.train import train_state as jts
from ood_object_detection_tpu_torch import run_bench
from ood_object_detection_tpu_torch.data import native_decode
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize)
from ood_object_detection_tpu_torch.meta import MetaConfig
from ood_object_detection_tpu_torch.utils.benchmark import (device_time,
                                                            throughput)
from ood_object_detection_tpu_torch.utils.from_jax import (load_jax_ema,
                                                           load_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG = 128
C = 90
# below D0@128's 3069 anchors: jax's top-k orders ties by index
TINY = dict(image_size=(IMG, IMG), fpn_cell_repeats=1, box_class_repeats=1,
            max_detection_points=3000)
BATCH = 2


def _jax_rows():
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        tail = json.load(f)["tail"]
    return [json.loads(line)["metric"] for line in tail.splitlines()
            if line.startswith("{")]


def test_default_row_names_are_the_jax_benchs():
    train = run_bench.train_metric("efficientdet_d0", 512, "bfloat16",
                                   "backbone", 128)
    names = [train] + [
        run_bench.predict_metric("efficientdet_d0", 512, 128, soft_nms=True,
                                 topk_method=topk, with_preproc=True)
        for topk in ("exact", "per_anchor")]
    assert names == _jax_rows()


def test_meta_and_loader_row_names_are_the_jax_benchs():
    jmc = JaxMetaConfig(img_size=256, qry_img_size=640)
    jax_name = (f"efficientdet_d0 MAML episode step (bfloat16, "
                f"{jmc.num_sup}sup@256, "
                f"{jmc.num_qry + jmc.num_zero_images}qry@640, "
                f"{jmc.steps} inner)")
    assert run_bench.meta_metric(
        "efficientdet_d0", "bfloat16", MetaConfig(img_size=256,
                                                  qry_img_size=640),
        256, 640) == jax_name
    assert run_bench.loader_metric(True, 128) == (
        "native C++ loader: jpeg decode + letterbox to 512x512, bs=128")
    assert run_bench.loader_metric(False, 128).startswith("PIL loader: ")
    assert run_bench.predict_metric(
        "efficientdet_d0", 512, 16, soft_nms=False, topk_method="per_anchor",
        with_preproc=False) == (
        "efficientdet_d0@512 e2e inference (fwd+NMS+OOD), bs=16")


@pytest.mark.parametrize("warmup,repeats,iters", [(1, 3, 4), (0, 1, 1),
                                                  (2, 5, 2)])
def test_device_time_counts_its_calls(warmup, repeats, iters):
    calls = []
    t = device_time(lambda x: calls.append(x), (7,), iters=iters,
                    warmup=warmup, repeats=repeats, device="cpu")
    assert len(calls) == warmup + repeats * iters and set(calls) == {7}
    assert t > 0 and np.isfinite(t)
    assert throughput(lambda: None, (), 4, iters=2, device="cpu") > 0


def test_device_time_never_drops_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            device_time(lambda: calls.append(1), (), device=device)
    assert not calls


def _predict_variables():
    """The JAX variables (numpy, seed 0), the class biases at the focal
    prior with classes 0-2 raised by 2."""
    cfg = jax_cfg("efficientdet_d0", num_classes=C, **TINY)
    variables = random_variables(
        lambda k: JaxDet(cfg).init(k, jnp.zeros((1, IMG, IMG, 3)), False), 0)
    predict = variables["params"]["class_net"]["predict"]["conv_pw"]
    bias = predict["bias"] - np.float32(4.6)
    bias.reshape(9, C)[:, :3] += np.float32(2.0)
    predict["bias"] = bias
    return variables


@pytest.fixture(scope="module")
def predict_variables():
    return _predict_variables()


def _dets_close(dets, ood, jdets, jood, box_atol):
    assert (dets[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=box_atol)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    np.testing.assert_allclose(ood, jood, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_preproc", [True, False],
                         ids=["preproc", "images"])
@pytest.mark.parametrize("topk", ["per_anchor", "exact"])
def test_predict_builder_matches_the_jax_full_graph(predict_variables,
                                                    topk, with_preproc):
    out = {}
    for dtype in ("float32", "bfloat16"):
        fn, args = run_bench.build_predict(
            "efficientdet_d0", BATCH, dtype, soft_nms=True, topk_method=topk,
            with_preproc=with_preproc, device="cpu", **TINY)
        load_jax_variables(fn.bench.model, predict_variables)
        dets, ood = fn(*args)
        jbench = JaxBench(JaxDet(jax_cfg(
            "efficientdet_d0", num_classes=C, soft_nms=True,
            compute_dtype=dtype, topk_method=topk, **TINY)),
            ood_method="energy")
        jargs = [jnp.asarray(a.numpy()) for a in args]
        if with_preproc:
            def full(v, cv, hw, dtype=dtype, jbench=jbench):
                pre = jax_letterbox(cv, hw, target_hw=(IMG, IMG),
                                    out_dtype=dtype)
                return pre["image"], jbench.forward_with_ood(v, pre["image"])
            jimage, (jdets, jood) = jax.jit(full)(predict_variables, *jargs)
            image = batched_letterbox_normalize(
                *args, target_hw=(IMG, IMG), out_dtype=dtype)["image"]
        else:
            jimage = jargs[0]
            jdets, jood = jax.jit(jbench.forward_with_ood)(predict_variables,
                                                           jimage)
            image = args[0]
        out[dtype] = (fn, image, dets, ood, jimage, jdets, jood)

    _, image, dets, ood, jimage, jdets, jood = out["float32"]
    np.testing.assert_allclose(image.numpy(), np.asarray(jimage), rtol=1e-5,
                               atol=1e-5)
    _dets_close(dets.numpy(), ood.numpy(), np.asarray(jdets),
                np.asarray(jood), box_atol=1e-4)

    fn, image, dets, ood, jimage, _, _ = out["bfloat16"]
    if with_preproc:
        assert image.dtype == torch.bfloat16
        got, want = to_numpy(image), np.asarray(jimage, np.float32)
        np.testing.assert_allclose(got, want, rtol=0, atol=0.06)
        assert np.mean(np.abs(got - want)) < 5e-3
    model = fn.bench.model
    with torch.no_grad():
        cls, box = model(image)
    jcls, jbox = jax.jit(lambda v, x: JaxDet(jax_cfg(
        "efficientdet_d0", num_classes=C, compute_dtype="bfloat16", **TINY)
    ).apply(v, x, False))(predict_variables, jimage)
    for ours, ref in zip(cls + box, list(jcls) + list(jbox)):
        np.testing.assert_allclose(to_numpy(ours), np.asarray(ref, np.float32),
                                   rtol=2 ** -7, atol=2 ** -7)
    janchors = JaxAnchors.from_config(model.config)
    levels = [jnp.asarray(to_numpy(t)).astype(jnp.bfloat16)
              for t in cls + box]
    pdets, pood = jax_generate_detections(
        levels[:5], levels[5:], jnp.asarray(janchors.boxes), C,
        max_detection_points=3000, soft_nms=True, ood_method="energy",
        topk_method=topk, nms_impl="xla", anchors=janchors)
    _dets_close(dets.numpy(), ood.numpy(), np.asarray(pdets),
                np.asarray(pood), box_atol=1e-4)


def test_train_builder_first_step_matches_jax():
    """The first step of ``build_train``'s call from one JAX state
    (numpy-seeded variables, a fresh optimizer), on the bench's batch:
    the loss and class loss to rtol 2e-3, grad_norm to 5e-2,
    num_positives exactly (tests/test_torch_train_bench.py's bf16 bars
    and their reasons); the box loss to the bf16 head bar it derives from,
    2^-7 (measured 3.5e-3 here: 612 positives over 90 classes; 9.2e-4 in
    that test's 8-class step)."""
    overrides = dict(image_size=(IMG, IMG), fpn_cell_repeats=1,
                     box_class_repeats=1)
    fn, (state, batch) = run_bench.build_train(
        "efficientdet_d0", BATCH, "bfloat16", freeze_bn="backbone",
        device="cpu", **overrides)
    cfg = jax_cfg("efficientdet_d0", num_classes=C).replace(
        compute_dtype="bfloat16", **overrides)
    model = JaxDet(cfg)
    tcfg = jax_train_config()
    variables = random_variables(
        lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), False), 0)
    tx = jts.make_optimizer(tcfg)
    jstate = jts.TrainState(step=jnp.zeros((), jnp.int32),
                            params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=tx.init(variables["params"]),
                            ema_params=variables["params"])
    step = jts.make_train_step(model, tx, JaxAnchors.from_config(cfg), tcfg,
                               donate=False, freeze_bn="backbone")
    load_jax_variables(state.model, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    load_jax_ema(state.ema_params, state.model, jstate.ema_params)
    _, ref = step(jstate, {k: jnp.asarray(v.numpy())
                           for k, v in batch.items()})
    metrics = fn(state, batch)
    assert state.step == 1
    for k, rtol in (("loss", 2e-3), ("class_loss", 2e-3),
                    ("box_loss", 2 ** -7), ("grad_norm", 5e-2)):
        np.testing.assert_allclose(float(metrics[k]), float(ref[k]),
                                   rtol=rtol, err_msg=k)
    assert float(metrics["num_positives"]) == float(ref["num_positives"])
    assert batch["image"].shape == (BATCH, IMG, IMG, 3)
    assert batch["bbox"].shape == (BATCH, 16, 4)


@pytest.fixture
def cpu_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.setenv("BENCH_ITERS", "1")
    return monkeypatch


def _printed(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_main_default_run_on_the_cpu(cpu_env, capsys):
    rows = run_bench.main(**TINY)
    assert _printed(capsys) == rows
    assert [r["metric"] for r in rows] == [
        "efficientdet_d0@128 train step (bfloat16, freeze_bn=backbone), bs=1",
        "efficientdet_d0@128 e2e inference (preproc+fwd+softNMS+OOD, "
        "topk=exact), bs=1",
        "efficientdet_d0@128 e2e inference (preproc+fwd+softNMS+OOD), bs=1"]
    assert run_bench.finite_rows(rows)
    assert all(r["vs_baseline"] is None and r["unit"] == "images/sec"
               for r in rows)


def test_main_failed_extra_row_keeps_the_north_star(cpu_env, capsys):
    def broken(*a, **k):
        raise MemoryError("out of memory")
    cpu_env.setattr(run_bench, "train_bench", broken)
    rows = run_bench.main(**TINY)
    assert rows[0]["metric"] == "extra bench row failed"
    assert rows[0]["error"] == "MemoryError: out of memory"
    assert rows[-1]["metric"].endswith("(preproc+fwd+softNMS+OOD), bs=1")
    assert len(rows) == 3 and not run_bench.finite_rows(rows)


@pytest.mark.parametrize("mode", ["train", "meta", "loader"])
def test_main_each_mode_on_the_cpu(cpu_env, capsys, mode):
    cpu_env.setenv("BENCH_MODE", mode)
    cpu_env.setenv("BENCH_META_QRY", str(IMG))
    cpu_env.setenv("BENCH_META_SUP", str(IMG))
    overrides = {} if mode == "loader" else \
        dict(fpn_cell_repeats=1, box_class_repeats=1) if mode == "meta" \
        else TINY
    rows = run_bench.main(**overrides)
    assert _printed(capsys) == rows and len(rows) == 1
    assert run_bench.finite_rows(rows)
    want = {"train": "efficientdet_d0@128 train step (bfloat16, "
                     "freeze_bn=backbone), bs=1",
            "meta": "efficientdet_d0 MAML episode step (bfloat16, "
                    "25sup@128, 31qry@128, 1 inner)",
            "loader": run_bench.loader_metric(native_decode.available(), 1)}
    assert rows[0]["metric"] == want[mode]


def test_main_without_a_card_exits(monkeypatch):
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_bench.main()


@pytest.mark.parametrize("patched", [False, True], ids=["here", "pil"])
def test_loader_row(cpu_env, capsys, monkeypatch, patched):
    if patched:
        monkeypatch.setattr(native_decode, "available", lambda: False)
    native = native_decode.available()
    assert native or patched, "the native data core loads in this image"
    row = run_bench.loader_bench(2, 2, num_images=5)
    assert row["metric"] == run_bench.loader_metric(native, 2)
    assert row["metric"].startswith("native C++" if native else "PIL")
    assert run_bench.finite_rows([row])
    assert _printed(capsys) == [row]
