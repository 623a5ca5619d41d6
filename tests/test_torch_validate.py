"""The port's offline evaluation entry point (``python -m
ood_object_detection_tpu_torch.validate``) on the CPU (``--device cpu``:
the kernels' plain versions), mirroring tests/test_validate.py, and held
against the JAX CLI on the same COCO-layout fixture with the same
weights (a reference-named ``.pth`` both load) at 128 px: the detections
each CLI hands its evaluator to the tolerances of
tests/test_torch_post_process.py (classes and the kept set equal, boxes to
rtol 1e-5 / atol 1e-4, scores to rtol 1e-4), and every metric of the two
JSON lines, the OOD mean and 95th percentile among them, to 1e-6
(images/s aside)."""
import importlib.util
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables

from ood_object_detection_tpu import validate as jax_validate
from ood_object_detection_tpu.config import get_efficientdet_config
from ood_object_detection_tpu.models import EfficientDet as JaxEfficientDet
from ood_object_detection_tpu_torch import validate
from ood_object_detection_tpu_torch.evaluation import PascalEvaluator
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

from test_flag_plumbing import _write_voc_difficult

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

CPU = ["--device", "cpu", "--mesh", "1", "--workers", "0"]


def test_validate_synthetic_smoke(tmp_path):
    out = tmp_path / "metrics.json"
    metrics = validate.main(CPU + [
        "--model", "efficientdet_d0", "--num-classes", "4",
        "--image-size", "128", "--batch-size", "2", "--max-batches", "2",
        "--data", "synthetic", "--ood-method", "energy", "--out", str(out)])
    assert metrics["images"] == 4
    assert np.isfinite(metrics["mAP@0.5IOU"])
    assert "meanCorLoc@0.5IOU" in metrics
    assert json.loads(out.read_text()) == metrics


def _voc(tmp_path, copies=0):
    root = tmp_path / "voc"
    root.mkdir()
    _write_voc_difficult(str(root))
    jpeg, ann = root / "VOC2007/JPEGImages", root / "VOC2007/Annotations"
    split = root / "VOC2007/ImageSets/Main/val.txt"
    names = split.read_text().split()
    for i in range(copies):
        shutil.copy(jpeg / f"{names[0]}.jpg", jpeg / f"{names[0]}_c{i}.jpg")
        shutil.copy(ann / f"{names[0]}.xml", ann / f"{names[0]}_c{i}.xml")
        names.append(f"{names[0]}_c{i}")
    split.write_text("\n".join(names) + "\n")
    return str(root)


def test_validate_voc_fixture(tmp_path):
    metrics = validate.main(CPU + [
        "--model", "efficientdet_d0", "--num-classes", "20",
        "--image-size", "128", "--batch-size", "1",
        "--dataset", "voc2007", "--data", _voc(tmp_path)])
    assert metrics["images"] == 1
    assert "mAP@0.5IOU" in metrics


def test_validate_partial_final_batch_not_dropped(tmp_path):
    """5 images at batch 2: batches of 2, 2 and 1, every image evaluated
    (run_validation counts 3 batches)."""
    root = _voc(tmp_path, copies=4)
    metrics = validate.main(CPU + [
        "--model", "efficientdet_d0", "--num-classes", "20",
        "--image-size", "128", "--batch-size", "2",
        "--dataset", "voc2007", "--data", root])
    assert metrics["images"] == 5, "final partial batch was dropped"
    args = validate.build_argparser().parse_args(CPU + [
        "--image-size", "128", "--batch-size", "2", "--dataset", "voc2007",
        "--data", root])
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=20, image_size=(128, 128), device="cpu")
    loader = validate.make_val_loader(args, bench.config, "cpu")
    _, times = validate.run_validation(bench, loader, PascalEvaluator(20))
    assert times["batches"] == 3
    assert {"load_s", "predict_s", "evaluate_s"} <= set(times)


def test_validate_refusals(tmp_path, monkeypatch):
    """A mesh of two outside a torchrun launch (it names the command), an
    orbax directory and a missing card raise rather than run something
    else."""
    with pytest.raises(ValueError, match="torchrun"):
        validate.main(["--mesh", "2", "--device", "cpu"])
    orbax = tmp_path / "ckpt"
    orbax.mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        validate.main(CPU + ["--checkpoint", str(orbax)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        validate.main(["--max-batches", "1", "--image-size", "128"])


def _record_detections(package, monkeypatch):
    """Every detection batch the CLI hands its evaluator, as numpy."""
    seen, make = [], package.create_evaluator

    def create(*args, **kwargs):
        evaluator = make(*args, **kwargs)
        add = evaluator.add_predictions_async

        def record(dets, target):
            seen.append(np.array(dets))
            return add(dets, target)
        evaluator.add_predictions_async = record
        return evaluator
    monkeypatch.setattr(package, "create_evaluator", create)
    return seen


def test_validate_matches_jax(tmp_path, monkeypatch):
    """chip_smoke's COCO-2017-layout split (4 images, batch 2) and a
    reference-named D0 ``.pth`` (90 classes) of weights drawn from numpy,
    which make the outputs depend on the image
    (tests/torch_parity_helpers.py), through both CLIs."""
    import ood_object_detection_tpu.evaluation as jev
    import ood_object_detection_tpu_torch.evaluation as ev

    root, pth = str(tmp_path / "coco"), str(tmp_path / "d0.pth")
    chip_smoke.write_coco_fixture(root, n=4)
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=90).replace(
        image_size=(128, 128))
    jmodel = JaxEfficientDet(cfg)
    model = create_model("efficientdet_d0", num_classes=90, device="cpu")
    load_jax_variables(model, random_variables(
        lambda k: jmodel.init(k, jnp.zeros((1, 128, 128, 3)),
                              training=False), seed=3))
    torch.save(chip_smoke.reference_state_dict(model), pth)

    common = ["--dataset", "coco2017", "--data", root, "--checkpoint", pth,
              "--image-size", "128", "--batch-size", "2", "--mesh", "1",
              "--workers", "1", "--ood-method", "energy"]
    seen, jseen = (_record_detections(ev, monkeypatch),
                   _record_detections(jev, monkeypatch))
    ours = validate.main(common + ["--device", "cpu"])
    ref = jax_validate.main(common)
    assert ours["images"] == ref["images"] == 4
    assert set(ours) == set(ref)
    for k in ref:
        if k != "img_per_sec":
            assert ours[k] == pytest.approx(ref[k], abs=1e-6), k
    assert len(seen) == len(jseen) == 2
    for dets, jdets in zip(seen, jseen):
        np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
        np.testing.assert_array_equal(dets[..., 4] > 0, jdets[..., 4] > 0)
        np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    assert sum(int((d[..., 4] > 0).sum()) for d in seen) > 20
