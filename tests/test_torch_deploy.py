"""The port's deploy path (``examples/deploy_infer.py``) against the JAX
package's, on the committed deploy-fixture JPEGs.

- Pipeline parity at 128 px: the JAX model's variables (filled from numpy,
  class biases at the focal prior with three classes raised) carried into
  the port by ``utils/from_jax``; on both sides ``NativeEvalLoader`` ->
  ``normalize_uint8`` -> ``forward_with_ood`` with soft-NMS and energy OOD,
  as the two CLIs run it (they then scale the boxes by ``img_scale``,
  which the loaders give bit-equal). In f32 the canvases are bit-equal,
  the normalised images agree to 1e-6 and the detections to
  tests/test_torch_post_process.py's tolerances (classes
  equal, boxes rtol 1e-5 / atol 1e-4 in the 128 px frame, scores rtol
  1e-4, OOD rtol 1e-5 / atol 1e-6). In bf16, the CLIs' dtype, the head
  outputs on the same images agree within two bf16 steps (rtol = atol =
  2^-7, as tests/test_torch_model.py); the bf16 detections are not held
  row for row, because soft-NMS over scores that tie to a bf16 step picks
  in another order when one logit rounds the other way.
- The golden fixture (``tests/deploy_fixture.build_checkpoint``:
  calibrated D0@512, 90 classes; JPEGs and ``golden.json`` committed),
  its weights read back with the JAX package's loader and carried across.
  Its pinned rows are near-ties: scores step by one bf16 logit step, and
  soft-NMS keeps the lowest anchor of a tie. So the rows follow the f32
  rounding of every conv sum, and only XLA's own arithmetic reproduces
  them: the JAX package's bf16 path matches all 50 rows, its f32 path
  misses most, and the port's bf16 path moves most of its own top rows
  when its conv sums are taken in f64 instead of f32
  (``test_golden_rows_follow_summation_order``, which prints the counts
  with ``-s``). What the rows determine whatever anchor wins a tie holds:
  per image the count, and the top rows' scores and OOD scores, each
  sorted (``test_golden_counts_scores_and_ood_hold``). The CLI against
  ``golden.json`` to tests/test_deploy_golden.py's tolerances (lines
  55-69) FAILS (``test_deploy_path_matches_golden``, 37 of the 50 rows
  unmatched): F3 in ROADMAP.md, a known deviation. It is marked slow, as
  the JAX test is (about 90 s alone with the fixture's build).
- The well-posed golden (``tests/data/deploy_fixture_torch/golden.json``,
  made by ``tests/deploy_fixture_torch.py`` with the JAX package's deploy
  path on the CPU, the same JPEGs and recipe of weights): of each image's
  first 10 rows only those that no other candidate of the same class
  contests (a box more than 3 px away, IoU above 0.3, a bf16 logit within
  2 steps): 32 of the 50 top rows. The JAX package's bf16 path matches
  all 32; its f32 path and the port's bf16 path miss most of them
  (``test_torch_golden_rows_follow_precision``, counts printed with
  ``-s``), so the rule does not make the rows independent of the rounding.
  The port's rows against every pinned row
  (``test_deploy_path_matches_torch_golden``) FAIL (27 of 32 unmatched)
  and the test is marked slow, as ``test_deploy_path_matches_golden`` is.
- What decides F3 (``test_torch_golden_pins_summation_order``): the
  unchanged JAX package on an exact reparametrisation of the golden's
  variables (the expanded channels of every MBConv block permuted: the
  same function in exact arithmetic, another order of the f32 sums) keeps
  its f32 heads within 1e-4 and misses 26 of the 32 pinned rows in bf16.
  The goldens pin XLA's CPU summation order, not the model; the two slow
  tests above hold the port to that order and are left as they are.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.bench import DetBenchPredict as JaxBench
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data import (
    NativeEvalLoader as JaxLoader,
    native_decode_available as jax_native_available,
    normalize_uint8 as jax_normalize,
)
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu_torch.bench import DetBenchPredict
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.data import (NativeEvalLoader,
                                                 native_decode_available,
                                                 normalize_uint8)
from ood_object_detection_tpu_torch.examples import deploy_infer
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from deploy_fixture import (  # noqa: E402
    FIXTURE_DIR,
    GOLDEN_PATH,
    N_IMAGES,
    build_checkpoint,
    summarize,
)
from deploy_fixture_torch import GOLDEN_PATH as TORCH_GOLDEN_PATH  # noqa: E402

IMG = 128
C = 90
# top 3000 of 3069 anchors: jax's CPU top-k is unstable at k = row length
OVERRIDES = dict(num_classes=C, image_size=(IMG, IMG), soft_nms=True,
                 max_detection_points=3000, compute_dtype="bfloat16")
THRESHOLD = 0.1           # the CLIs' --score-threshold


def _matched(row, candidates, box_px):
    return any(
        c["class"] == row["class"]
        and np.allclose(c["box_xyxy"], row["box_xyxy"], atol=box_px)
        and abs(c["score"] - row["score"]) <= 0.02
        and abs(c["ood_score"] - row["ood_score"]) <= 0.2
        for c in candidates)


def _variables(cfg):
    variables = random_variables(
        lambda k: JaxDet(cfg).init(k, jnp.zeros((1, IMG, IMG, 3)), False), 0)
    predict = variables["params"]["class_net"]["predict"]["conv_pw"]
    bias = predict["bias"] - np.float32(4.6)
    bias.reshape(9, C)[:, (3, 17, 42)] += np.float32(2.6)
    predict["bias"] = bias
    return variables


def _port_model(variables, dtype):
    model = EfficientDet(get_efficientdet_config(
        "efficientdet_d0", **OVERRIDES).replace(compute_dtype=dtype))
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last).eval()


@pytest.fixture(scope="module")
def pipelines():
    """The five JPEGs through both loaders (128 px, batch 3) and the JAX
    model's variables."""
    if not (native_decode_available() and jax_native_available()):
        pytest.skip("the native data core does not load here (libjpeg)")
    paths = sorted(os.path.join(FIXTURE_DIR, f)
                   for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))
    ours = list(NativeEvalLoader(paths, (IMG, IMG), 3))
    want = list(JaxLoader(paths, (IMG, IMG), 3))
    variables = _variables(jax_cfg("efficientdet_d0", **OVERRIDES).replace(
        compute_dtype="float32"))
    return ours, want, variables


def test_pipeline_matches_jax_f32(pipelines):
    ours, want, variables = pipelines
    cfg = jax_cfg("efficientdet_d0", **OVERRIDES).replace(
        compute_dtype="float32")
    jax_bench = JaxBench(JaxDet(cfg), ood_method="energy")
    jax_run = jax.jit(lambda v, x: jax_bench.forward_with_ood(v, x))
    bench = DetBenchPredict(_port_model(variables, "float32"),
                            ood_method="energy")
    kept = 0
    for a, b in zip(ours, want):
        assert a["path"] == b["path"]
        for key in ("image", "img_scale", "img_size"):
            np.testing.assert_array_equal(a[key], b[key])
        x = normalize_uint8(torch.from_numpy(a["image"]))
        jx = jax_normalize(b["image"])
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                                   atol=1e-6)
        dets, ood = bench.forward_with_ood(x)
        jdets, jood = jax_run(variables, jx)
        dets, jdets = dets.numpy(), np.asarray(jdets)
        kept += int((dets[..., 4] >= THRESHOLD).sum())
        np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
        np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
        np.testing.assert_allclose(ood.numpy(), np.asarray(jood), rtol=1e-5,
                                   atol=1e-6)
    assert kept > 20                  # rows above the CLI's 0.1 threshold


def test_pipeline_heads_match_jax_bf16(pipelines):
    ours, want, variables = pipelines
    cfg = jax_cfg("efficientdet_d0", **OVERRIDES)
    jax_apply = jax.jit(lambda v, x: JaxDet(cfg).apply(v, x, False))
    model = _port_model(variables, "bfloat16")
    for a, b in zip(ours, want):
        with torch.no_grad():
            cls, box = model(normalize_uint8(torch.from_numpy(a["image"])))
        jcls, jbox = jax_apply(variables, jax_normalize(b["image"]))
        for got, ref in zip(cls + box, list(jcls) + list(jbox)):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=2 ** -7, atol=2 ** -7)


def _rows(dets, ood, scales):
    """The CLI's rows: boxes scaled back by ``img_scale``, scores at or
    above its threshold."""
    out = []
    for d, o, scale in zip(dets, ood, scales):
        keep = d[:, 4] >= THRESHOLD
        out.append([{"box_xyxy": [float(c) * float(scale) for c in r[:4]],
                     "score": float(r[4]), "class": int(r[5]),
                     "ood_score": float(q)}
                    for r, q in zip(d[keep], o[keep])])
    return out


def _unmatched(reference, got, top=10):
    """How many of each image's first ``top`` reference rows no row of
    ``got`` matches to the golden's tolerances."""
    return sum(not _matched(row, cands, 3.0)
               for rows, cands in zip(reference, got) for row in rows[:top])


def _f64_sums(x, weight, bias=None, *args):
    """F.conv2d with its sum taken in f64, rounded once to x's dtype."""
    y = _CONV2D(x.double(), weight.double(),
                None if bias is None else bias.double(), *args)
    return y.to(x.dtype)


_CONV2D = torch.nn.functional.conv2d


@pytest.fixture(scope="module")
def golden_case(tmp_path_factory):
    """The golden fixture's weights (JAX checkpoint -> port variables file)
    and, on its five canvases at 512, the rows of: the JAX package's bf16
    and f32 paths; the port's bf16 path with its conv sums in f32 and in
    f64."""
    if not (native_decode_available() and jax_native_available()):
        pytest.skip("the native data core does not load here (libjpeg)")
    from ood_object_detection_tpu.factory import create_model as jax_create
    from ood_object_detection_tpu.train.checkpoint import restore_variables
    from ood_object_detection_tpu_torch.train.checkpoint import \
        save_variables

    tmp = tmp_path_factory.mktemp("golden")
    like = jax.eval_shape(lambda: jax_create(
        "efficientdet_d0", bench_task="predict", num_classes=90, seed=0)[1])
    variables = restore_variables(build_checkpoint(str(tmp)), like)
    model = EfficientDet(get_efficientdet_config(
        "efficientdet_d0", num_classes=90, compute_dtype="bfloat16",
        soft_nms=True))
    report = load_jax_variables(model, variables)
    assert not report["missing"] and not report["unexpected"]
    ckpt = str(tmp / "deploy_golden.pt")
    save_variables(ckpt, model.state_dict())
    model = model.to(memory_format=torch.channels_last).eval()

    paths = sorted(os.path.join(FIXTURE_DIR, f)
                   for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))
    batch = next(iter(NativeEvalLoader(paths, (512, 512), N_IMAGES)))
    case = {"ckpt": ckpt, "scales": batch["img_scale"]}
    x = normalize_uint8(torch.from_numpy(batch["image"]))
    bench = DetBenchPredict(model, ood_method="energy")
    for sums in ("f32", "f64"):
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            if sums == "f64":
                mp.setattr(torch.nn.functional, "conv2d", _f64_sums)
            dets, ood = bench.forward_with_ood(x)
        case[f"port_{sums}"] = _rows(dets.numpy(), ood.numpy(),
                                     case["scales"])
    jx = jax_normalize(batch["image"])
    case["variables"], case["jx"] = variables, jx
    for dtype in ("bfloat16", "float32"):
        cfg = jax_cfg("efficientdet_d0", num_classes=90, compute_dtype=dtype,
                      soft_nms=True)
        jax_bench = JaxBench(JaxDet(cfg), ood_method="energy")
        case[f"jax_run_{dtype}"] = jax.jit(jax_bench.forward_with_ood)
        dets, ood = case[f"jax_run_{dtype}"](variables, jx)
        case[f"jax_{dtype}"] = _rows(np.asarray(dets), np.asarray(ood),
                                     case["scales"])
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    case["golden"] = [img["rows"] for img in golden]
    case["golden_counts"] = [img["num_detections"] for img in golden]
    return case


def test_golden_rows_follow_summation_order(golden_case):
    """The witnesses of F3: the golden's rows are reproduced by the JAX
    package's bf16 path alone, and the port's own top rows move with the
    precision of its conv sums. Counts print with ``-s``."""
    golden = golden_case["golden"]
    counts = {
        "jax bf16 vs golden": _unmatched(golden, golden_case["jax_bfloat16"]),
        "jax f32 vs golden": _unmatched(golden, golden_case["jax_float32"]),
        "port bf16 vs golden": _unmatched(golden, golden_case["port_f32"]),
        "port bf16, f64 sums vs f32 sums": _unmatched(
            golden_case["port_f32"], golden_case["port_f64"]),
    }
    print(f"golden fixture, top rows unmatched of 50: {counts}")
    assert counts["jax bf16 vs golden"] == 0
    assert counts["jax f32 vs golden"] >= 20
    assert counts["port bf16, f64 sums vs f32 sums"] >= 20


def test_golden_counts_scores_and_ood_hold(golden_case):
    """What the golden's rows determine whatever anchor wins a tie: per
    image the count within 12, and the pinned rows' scores and OOD
    scores, each sorted, within 0.02 and 0.2 of the port's first rows."""
    rows = golden_case["port_f32"]
    for got, want, count in zip(rows, golden_case["golden"],
                                golden_case["golden_counts"]):
        assert abs(len(got) - count) <= 12, (len(got), count)
        top = sorted(got, key=lambda r: -r["score"])[:len(want)]
        for key, tol in (("score", 0.02), ("ood_score", 0.2)):
            np.testing.assert_allclose(
                sorted(r[key] for r in top), sorted(r[key] for r in want),
                rtol=0, atol=tol)


def _torch_golden():
    with open(TORCH_GOLDEN_PATH) as f:
        return json.load(f)


def test_torch_golden_rows_follow_precision(golden_case):
    """The witnesses of F3 on the well-posed golden: at least 20 rows
    pinned, all of them reproduced by the JAX package's bf16 path (the
    golden's own arithmetic), and most of them moved by the JAX f32 path
    and by the port's bf16 path. Counts print with ``-s``."""
    golden = _torch_golden()
    assert golden["pinned"] >= 20
    pinned = [img["rows"] for img in golden["images"]]
    counts = {key: _unmatched(pinned, golden_case[key])
              for key in ("jax_bfloat16", "jax_float32", "port_f32")}
    print(f"well-posed golden, {golden['pinned']} pinned rows, unmatched: "
          f"{counts}")
    assert counts["jax_bfloat16"] == 0
    assert counts["jax_float32"] >= 20
    assert counts["port_f32"] >= 20


PERMUTATION_SEED = 11


def _permute_expanded_channels(variables, seed=PERMUTATION_SEED):
    """An exact reparametrisation of the EfficientNet backbone: in every
    MBConv block with an expansion, the expanded channels are permuted
    (one numpy permutation a block): the expansion conv's output axis and
    its BatchNorm, the depthwise conv and its BatchNorm, the
    squeeze-excite reduce conv's input axis and its expand conv's output
    axis and bias, and the project conv's input axis. The function is the
    same in exact arithmetic; only the order of the f32 sums over the
    expanded channels (the project conv, the squeeze-excite reduce) moves.
    Returns a new variable tree; ``variables`` is not touched."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    backbone, bn_stats = params["backbone"], stats["backbone"]
    blocks = sorted(name for name, block in backbone.items()
                    if "conv_pw" in block and "conv_pwl" in block)
    for name in blocks:
        block, block_stats = backbone[name], bn_stats[name]
        mid = block["conv_pw"]["kernel"].shape[-1]
        perm = rng.permutation(mid)
        block["conv_pw"]["kernel"] = block["conv_pw"]["kernel"][..., perm]
        block["conv_dw"]["kernel"] = block["conv_dw"]["kernel"][..., perm]
        for bn in ("bn1", "bn2"):
            for leaf in ("scale", "bias"):
                block[bn][leaf] = block[bn][leaf][perm]
            for leaf in ("mean", "var"):
                block_stats[bn][leaf] = block_stats[bn][leaf][perm]
        se = block["se"]
        se["conv_reduce"]["kernel"] = se["conv_reduce"]["kernel"][:, :, perm]
        se["conv_expand"]["kernel"] = se["conv_expand"]["kernel"][..., perm]
        se["conv_expand"]["bias"] = se["conv_expand"]["bias"][perm]
        block["conv_pwl"]["kernel"] = block["conv_pwl"]["kernel"][:, :, perm]
    return {"params": params, "batch_stats": stats}, len(blocks)


# the permuted JAX bf16 run misses 26 of the 32 pinned rows on the CPU
# (the port's bf16 path: 27); asserted less a margin of 4
PERMUTED_BF16_UNMATCHED_AT_LEAST = 22


def test_torch_golden_pins_summation_order(golden_case):
    """F3's deciding witness, in JAX alone: the well-posed golden's pinned
    rows against the unchanged JAX package run on exactly reparametrised
    variables (``_permute_expanded_channels``). In f32 the class and box
    head outputs of both variable sets agree to rtol 1e-5 / atol 1e-5, so
    the function is the same; the JAX bf16 deploy path on the permuted
    variables then misses most of the pinned rows that it matches on the
    original ones. So the golden pins XLA's CPU summation order, not the
    model. The count prints with ``-s``.

    The f32 check's atol is 1e-4: at 1e-5 it fails in 760 of 737,280
    head outputs, by at most 3.6e-5 (the reordered f32 sums, carried
    through the network)."""
    variables, jx = golden_case["variables"], golden_case["jx"]
    permuted, n_blocks = _permute_expanded_channels(variables)
    assert n_blocks == 15

    cfg = jax_cfg("efficientdet_d0", num_classes=90,
                  compute_dtype="float32", soft_nms=True)
    heads = jax.jit(lambda v, x: JaxDet(cfg).apply(v, x, False))
    gap = 0.0
    for want, got in zip(jax.tree_util.tree_leaves(heads(variables, jx)),
                         jax.tree_util.tree_leaves(heads(permuted, jx))):
        want, got = np.asarray(want), np.asarray(got)
        gap = max(gap, float(np.abs(got - want).max()))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)

    dets, ood = golden_case["jax_run_bfloat16"](permuted, jx)
    rows = _rows(np.asarray(dets), np.asarray(ood), golden_case["scales"])
    golden = _torch_golden()
    pinned = [img["rows"] for img in golden["images"]]
    unmatched = _unmatched(pinned, rows)
    print(f"well-posed golden, {golden['pinned']} pinned rows: the JAX bf16 "
          f"path on permuted expanded channels leaves {unmatched} unmatched "
          f"(on the original variables "
          f"{_unmatched(pinned, golden_case['jax_bfloat16'])}); f32 heads "
          f"of the two variable sets at most {gap:.3g} apart")
    assert _unmatched(pinned, golden_case["jax_bfloat16"]) == 0
    assert unmatched >= PERMUTED_BF16_UNMATCHED_AT_LEAST


@pytest.mark.slow
def test_deploy_path_matches_torch_golden(golden_case):
    """The port's rows on the golden fixture (bf16, the CPU) against every
    row of the well-posed golden, to tests/test_deploy_golden.py's
    tolerances; the counts within 12. The pinned rows follow XLA's CPU
    summation order (``test_torch_golden_pins_summation_order``), so this
    fails on the port (F3, a known deviation)."""
    golden = _torch_golden()
    assert golden["pinned"] >= 20
    rows = golden_case["port_f32"]
    unmatched = []
    for got, want in zip(rows, golden["images"]):
        assert abs(len(got) - want["num_detections"]) <= 12
        unmatched += [row for row in want["rows"]
                      if not _matched(row, got, 3.0)]
    assert not unmatched, (f"{len(unmatched)} of {golden['pinned']} pinned "
                           f"rows unmatched, the first: {unmatched[:2]}")


@pytest.mark.slow
def test_deploy_path_matches_golden(golden_case, tmp_path):
    """The port's CLI with the golden fixture's weights on the CPU against
    tests/data/deploy_fixture/golden.json, whose rows pin XLA's CPU
    summation order (F3, a known deviation): fails on the port."""
    with open(GOLDEN_PATH) as f:
        golden = json.load(f)
    out = str(tmp_path / "dets.json")
    results = deploy_infer.main([
        "--image-dir", FIXTURE_DIR, "--checkpoint", golden_case["ckpt"],
        "--batch-size", str(N_IMAGES), "--out", out, "--score-threshold",
        "0.1", "--device", "cpu"])
    with open(out) as f:
        assert json.load(f) == results
    got = summarize(results)

    assert [g["image"] for g in got] == [g["image"] for g in golden]
    assert len(got) == N_IMAGES
    full = {os.path.basename(r["path"]): r["detections"] for r in results}
    unmatched = []
    for g_img, e_img in zip(got, golden):
        assert abs(g_img["num_detections"] - e_img["num_detections"]) <= 12, \
            (g_img["image"], g_img["num_detections"],
             e_img["num_detections"])
        assert g_img["num_detections"] > 0, "deploy path emitted nothing"
        unmatched += [(g_img["image"], er) for er in e_img["rows"]
                      if not _matched(er, full[g_img["image"]], 3.0)]
    pinned = sum(len(e["rows"]) for e in golden)
    assert not unmatched, (f"{len(unmatched)} of {pinned} golden rows "
                           f"unmatched, the first: {unmatched[:2]}")
