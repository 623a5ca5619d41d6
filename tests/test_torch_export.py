"""The port's serving export (``ood_object_detection_tpu_torch/export.py``),
mirroring tests/test_export.py: a saved ``torch.export`` artifact holds the
weights, reproduces the live bench bit for bit (``torch.equal``), serves
any batch when exported with a symbolic batch, and with ``with_preproc``
takes uint8 canvases + true (h, w).

The bench is D0 at 128 px with one BiFPN cell and one head repeat, 8
classes, bf16 compute (so the packed-key path, K2's operator, is in the
program), soft-NMS and energy OOD, three class biases raised so that K1's
operator keeps detections. Each artifact is exported, saved and loaded
with ``device="cpu"`` once, in a module-scoped fixture (about 15 s each on
a CPU). On the CPU the operators run the kernels' plain versions.
"""
import json
import os

import numpy as np
import pytest
import torch

import ood_object_detection_tpu_torch as pkg
from ood_object_detection_tpu_torch import export as ex
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize)
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.ops import cuda_nms, cuda_reduce

IMG = 128
NUM_CLASSES = 8


@pytest.fixture(scope="module")
def bench():
    b = create_model("efficientdet_d0", bench_task="predict",
                     num_classes=NUM_CLASSES, image_size=(IMG, IMG),
                     fpn_cell_repeats=1, box_class_repeats=1,
                     compute_dtype="bfloat16", soft_nms=True,
                     ood_method="energy", device="cpu")
    with torch.no_grad():
        b.model.class_net.predict_bias().view(9, NUM_CLASSES)[:, :3] += 2.0
    # In some fresh CPU processes the first exp / sum / log reduce rounds
    # differently from every later one (the energy moves slightly;
    # after one warm-up call it does not). The tests hold the artifact to
    # the live bench bit for bit, so one throwaway forward comes first.
    b.forward_with_ood(_images(1, 99))
    return b


def _export_save_load(bench, path, **kw):
    ep = ex.export_predict(bench, **kw)
    ex.save_artifact(str(path), ep, bench)
    return ep, ex.load_artifact(str(path), device="cpu")


@pytest.fixture(scope="module")
def plain_artifact(bench, tmp_path_factory):
    """f32 images in, symbolic batch."""
    path = tmp_path_factory.mktemp("art") / "plain"
    return (path, *_export_save_load(bench, path, batch_size=None))


@pytest.fixture(scope="module")
def preproc_artifact(bench, tmp_path_factory):
    """uint8 canvases + int32 true (h, w) in, symbolic batch."""
    path = tmp_path_factory.mktemp("art") / "pre"
    return (path, *_export_save_load(bench, path, batch_size=None,
                                     with_preproc=True))


def _images(batch, seed):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -2, 2, (batch, IMG, IMG, 3)).astype(np.float32))


def _assert_equal(got, want):
    """torch.equal, naming how many elements differ and by how much."""
    assert got.shape == want.shape and got.dtype == want.dtype
    differ = got != want
    assert torch.equal(got, want), (
        f"{int(differ.sum())} of {got.numel()} elements differ, by up to "
        f"{float((got - want).abs().max())}, at "
        f"{differ.nonzero()[:5].tolist()}")


def _operators(ep):
    """The port's custom operators that the program calls, by name."""
    names = []
    for _, module in ep.graph_module.named_modules():
        graph = getattr(module, "graph", None)
        if graph is None:
            continue
        names += [str(n.target) for n in graph.nodes
                  if n.op == "call_function" and
                  str(n.target).startswith("ood_detection.")]
    return sorted(names)


def test_roundtrip_matches_live_bench(bench, plain_artifact):
    path, _, module = plain_artifact
    x = _images(2, 0)
    dets, ood = module(x)
    ref_dets, ref_ood = bench.forward_with_ood(x)
    assert int((ref_dets[..., 4] > 0).sum()) > 0
    _assert_equal(dets, ref_dets)
    _assert_equal(ood, ref_ood)
    manifest = module.manifest
    assert manifest["model"] == "efficientdet_d0"
    assert manifest["num_classes"] == NUM_CLASSES
    assert manifest["ood_method"] == "energy" and manifest["soft_nms"]
    assert manifest["device"] == "cpu"
    assert manifest["torch_version"] == torch.__version__
    assert os.path.exists(os.path.join(path, ex.ARTIFACT_FILE))


def test_symbolic_batch_serves_any_batch_size(bench, plain_artifact):
    _, _, module = plain_artifact
    batch_dim = module.manifest["input_signature"][0]["shape"][0]
    assert not batch_dim.isdigit()              # symbolic, not the traced 2
    for bs in (1, 3):
        x = _images(bs, bs)
        dets, ood = module(x)
        assert dets.shape == (bs, 100, 6) and ood.shape == (bs, 100)
        ref_dets, ref_ood = bench.forward_with_ood(x)
        _assert_equal(dets, ref_dets)
        _assert_equal(ood, ref_ood)


# true (h, w) in a 128 x 128 canvas: sides whose f32 scale to 128 rounds
# below 128 / side (tight_300x400_to_512 of tests/test_torch_preproc.py,
# scaled to 128), and a batch of 1 past the traced batch of 2
TIGHT = {
    "tight_94x121_61x123_83x47": [[94, 121], [61, 123], [83, 47]],
    "tight_1_image_115x128": [[115, 128]],
}


@pytest.mark.parametrize("case", sorted(TIGHT))
def test_preproc_artifact_matches_the_live_path(bench, preproc_artifact,
                                                case):
    _, _, module = preproc_artifact
    true_hw = torch.tensor(TIGHT[case], dtype=torch.int32)
    canvases = torch.from_numpy(np.random.default_rng(len(case)).integers(
        0, 256, (len(true_hw), IMG, IMG, 3), dtype=np.uint8))
    dets, ood = module(canvases, true_hw)
    pre = batched_letterbox_normalize(canvases, true_hw,
                                      target_hw=(IMG, IMG),
                                      out_dtype="bfloat16")
    ref_dets, ref_ood = bench.forward_with_ood(pre["image"])
    assert dets.shape == (len(true_hw), 100, 6)
    _assert_equal(dets, ref_dets)
    _assert_equal(ood, ref_ood)


def test_program_keeps_the_operators(plain_artifact, preproc_artifact):
    """The exported programs call K2's and K1's operators (and the
    letterbox's): on the card they launch the kernels. On the CPU the
    artifact runs the plain versions and counts no launch."""
    assert _operators(plain_artifact[1]) == [
        "ood_detection.batched_nms.default",
        "ood_detection.key_energy_reduce.default"]
    assert _operators(preproc_artifact[1]) == [
        "ood_detection.batched_nms.default",
        "ood_detection.key_energy_reduce.default",
        "ood_detection.letterbox_normalize.default"]
    before = (cuda_nms.batched_nms.launches,
              cuda_reduce.key_energy_reduce.launches)
    plain_artifact[2](_images(1, 7))
    assert (cuda_nms.batched_nms.launches,
            cuda_reduce.key_energy_reduce.launches) == before


def test_manifest_derives_preproc_from_signature(plain_artifact,
                                                 preproc_artifact):
    """save_artifact needs no with_preproc flag: it is read from the
    program's input signature (uint8 canvases + int32 true_hw)."""
    with open(os.path.join(preproc_artifact[0], ex.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    assert manifest["with_preproc"] is True
    assert [s["dtype"] for s in manifest["input_signature"]] == [
        "uint8", "int32"]
    with open(os.path.join(plain_artifact[0], ex.MANIFEST_FILE)) as f:
        manifest2 = json.load(f)
    assert manifest2["with_preproc"] is False
    assert manifest2["input_signature"][0]["dtype"] == "float32"


def test_top_level_api_exposes_export():
    assert pkg.export_predict is ex.export_predict
    assert pkg.save_artifact is ex.save_artifact
    assert pkg.load_artifact is ex.load_artifact


def test_load_without_device_needs_cuda(plain_artifact, monkeypatch):
    """load_artifact puts the program on the card unless a device is
    named, and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.load_artifact(str(plain_artifact[0]))
