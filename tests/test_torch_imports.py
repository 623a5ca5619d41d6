"""The PyTorch port stands alone: it imports neither jax / flax nor the
JAX package, and its entry points do not drop to the CPU unasked."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "ood_object_detection_tpu_torch"
FORBIDDEN = ("jax", "flax", "ood_object_detection_tpu")
PUBLIC_MODULES = (
    "ood_object_detection_tpu_torch",
    "ood_object_detection_tpu_torch.bench",
    "ood_object_detection_tpu_torch.factory",
    "ood_object_detection_tpu_torch.data.device_preproc",
    "ood_object_detection_tpu_torch.ops.post_process",
    "ood_object_detection_tpu_torch.ops.cuda_nms",
    "ood_object_detection_tpu_torch.ops.cuda_reduce",
    "ood_object_detection_tpu_torch.ops.cuda_labeler",
    "ood_object_detection_tpu_torch.ops.cuda_update",
    "ood_object_detection_tpu_torch.ops.target_assigner",
    "ood_object_detection_tpu_torch.ops.losses",
    "ood_object_detection_tpu_torch.config.train_config",
    "ood_object_detection_tpu_torch.train",
    "ood_object_detection_tpu_torch.train.train_state",
    "ood_object_detection_tpu_torch.utils.from_jax",
    "ood_object_detection_tpu_torch.meta",
    "ood_object_detection_tpu_torch.meta.config",
    "ood_object_detection_tpu_torch.meta.projection",
    "ood_object_detection_tpu_torch.meta.clustering",
    "ood_object_detection_tpu_torch.meta.inner_loop",
    "ood_object_detection_tpu_torch.meta.episode",
    "ood_object_detection_tpu_torch.data.dataset",
    "ood_object_detection_tpu_torch.data.episodic",
    "ood_object_detection_tpu_torch.data.parsers",
    "ood_object_detection_tpu_torch.data.transforms",
    "ood_object_detection_tpu_torch.data.input_config",
    "ood_object_detection_tpu_torch.data.dataset_factory",
    "ood_object_detection_tpu_torch.evaluation",
    "ood_object_detection_tpu_torch.evaluation.metrics",
    "ood_object_detection_tpu_torch.evaluation.object_detection_evaluation",
    "ood_object_detection_tpu_torch.evaluation.native",
    "ood_object_detection_tpu_torch.evaluation.coco_eval",
    "ood_object_detection_tpu_torch.evaluation.masks",
    "ood_object_detection_tpu_torch.evaluation.evaluators",
    "ood_object_detection_tpu_torch.utils.checkpoint_convert",
    "ood_object_detection_tpu_torch.validate",
    "ood_object_detection_tpu_torch.data",
    "ood_object_detection_tpu_torch.data.random_erasing",
    "ood_object_detection_tpu_torch.data.pretrain_stream",
    "ood_object_detection_tpu_torch.data.metadata",
    "ood_object_detection_tpu_torch.train.checkpoint",
    "ood_object_detection_tpu_torch.train.pretrain",
    "ood_object_detection_tpu_torch.meta.train_driver",
    "ood_object_detection_tpu_torch.utils",
    "ood_object_detection_tpu_torch.utils.profiling",
    "ood_object_detection_tpu_torch.utils.pretrained",
    "ood_object_detection_tpu_torch.export",
    "ood_object_detection_tpu_torch.data.native_decode",
    "ood_object_detection_tpu_torch.examples",
    "ood_object_detection_tpu_torch.examples.deploy_infer",
    "ood_object_detection_tpu_torch.models",
    "ood_object_detection_tpu_torch.models.backbone",
    "ood_object_detection_tpu_torch.models.csp",
    "ood_object_detection_tpu_torch.models.anchor_net",
    "ood_object_detection_tpu_torch.parallel",
    "ood_object_detection_tpu_torch.parallel.mesh",
    "ood_object_detection_tpu_torch.parallel.spatial",
    "ood_object_detection_tpu_torch.ops",
    "ood_object_detection_tpu_torch.ops.nms",
    "ood_object_detection_tpu_torch.ops.boxes",
    "ood_object_detection_tpu_torch.ops.box_coder",
    "ood_object_detection_tpu_torch.examples.open_set_demo",
    "ood_object_detection_tpu_torch.examples.selection_quality",
    "ood_object_detection_tpu_torch.run_bench",
    "ood_object_detection_tpu_torch.utils.benchmark",
    "ood_object_detection_tpu_torch.examples.train_roofline",
    "ood_object_detection_tpu_torch.examples.run_roofline_sweep",
    "ood_object_detection_tpu_torch.examples.profile_kernel_stats",
)


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.append(node.module)
    assert not [m for m in imported if _forbidden(m)]


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        f"for m in {PUBLIC_MODULES!r}: __import__(m)\n"
        "print(sorted(set(sys.modules) - before))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True, timeout=120)
    loaded = eval(out.stdout.strip().splitlines()[-1])
    assert "ood_object_detection_tpu_torch.ops.cuda_nms" in loaded
    assert "ood_object_detection_tpu_torch.ops.cuda_labeler" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_public_api_exports_load_no_jax():
    """The names the JAX package exports from ``ops`` and ``models`` (the
    public API's remainder), imported in a fresh process: no jax."""
    code = (
        "import sys\n"
        "from ood_object_detection_tpu_torch.ops import (post_process, "
        "batched_nms, batched_soft_nms, class_offset_boxes, "
        "pairwise_iou_xyxy, clip_boxes_yxyx, yxyx_to_xyxy, xyxy_to_yxyx, "
        "decode_box_outputs)\n"
        "from ood_object_detection_tpu_torch.models import (BiFpn, "
        "BiFpnLayer, Fnode, FpnCombine, HeadNet, ConvBnAct, SeparableConv, "
        "SqueezeExcite, ResampleFeatureMap, get_act, interpolate)\n"
        "from ood_object_detection_tpu_torch.config.train_config import "
        "TrainConfig\n"
        "assert TrainConfig().eval_metric == 'map'\n"
        "assert callable(post_process) and callable(batched_nms)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'ood_object_detection_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_top_level_names_load_no_jax():
    """Every top-level name (the JAX package's, and ``ops``) resolved in a
    fresh process, and ``utils``' exports imported: no jax."""
    code = (
        "import sys\n"
        "import ood_object_detection_tpu_torch as odt\n"
        "values = [getattr(odt, n) for n in odt.__all__]\n"
        "assert odt.ops.__name__ == 'ood_object_detection_tpu_torch.ops'\n"
        "assert callable(odt.create_model) and len(values) == 24\n"
        "from ood_object_detection_tpu_torch.utils import (device_time, "
        "load_pretrained, merge_into_variables, PRETRAINED_URLS)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'ood_object_detection_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_bench_tools_without_device_need_cuda(monkeypatch):
    from ood_object_detection_tpu_torch import run_bench
    from ood_object_detection_tpu_torch.examples import train_roofline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        run_bench.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_roofline.main(["--skip-measure", "--image-size", "128"])


@pytest.mark.parametrize("example", ["open_set_demo", "selection_quality"])
def test_examples_without_device_need_cuda(monkeypatch, example):
    import importlib
    module = importlib.import_module(
        f"ood_object_detection_tpu_torch.examples.{example}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--steps", "1", "--image-size", "128"])


def test_the_loader_without_device_needs_cuda(monkeypatch):
    from ood_object_detection_tpu_torch.data.dataset import (
        PrefetchLoader, SyntheticDetectionDataset)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrefetchLoader(SyntheticDetectionDataset(num_images=2), 2)


@pytest.mark.parametrize("bench_task", ["predict", "train"])
def test_create_model_without_device_needs_cuda(monkeypatch, bench_task):
    from ood_object_detection_tpu_torch.factory import create_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("efficientdet_d0", bench_task=bench_task)


def test_meta_trainer_without_device_needs_cuda(monkeypatch):
    from ood_object_detection_tpu_torch.config import get_efficientdet_config
    from ood_object_detection_tpu_torch.meta import (MetaConfig, MetaTrainer,
                                                     ProjectionNet)
    from ood_object_detection_tpu_torch.models.efficientdet import (
        EfficientDet)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=1).replace(
        image_size=(128, 128), fpn_cell_repeats=1, box_class_repeats=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MetaTrainer(EfficientDet(cfg), ProjectionNet(64), MetaConfig(), cfg,
                    [576, 144, 36])


def test_unported_train_options_raise():
    """A mesh of more processes than the launch has raises and names
    torchrun, rather than train on one process, as a bad freeze_bn scope
    raises. drop_path, remat_stages, remat_fpn and remat_heads are ported:
    each builds the model with the same tensors."""
    from ood_object_detection_tpu_torch.config import (
        default_detection_train_config, get_efficientdet_config)
    from ood_object_detection_tpu_torch.models.efficientdet import (
        EfficientDet)
    from ood_object_detection_tpu_torch.ops.anchors import Anchors
    from ood_object_detection_tpu_torch.train import make_train_step
    cfg = get_efficientdet_config("efficientdet_d0").replace(
        image_size=(128, 128))
    model = EfficientDet(cfg)
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    for option in (dict(backbone_args={"drop_path_rate": 0.2}),
                   dict(backbone_args={"remat_stages": 2}),
                   dict(remat_fpn=True), dict(remat_heads=True)):
        built = EfficientDet(cfg.replace(**option))
        assert {k: v.shape for k, v in built.state_dict().items()} == shapes
    from ood_object_detection_tpu_torch.parallel import create_mesh
    make_train_step(model, None, Anchors.from_config(cfg),
                    default_detection_train_config(),
                    mesh=create_mesh((1,), device="cpu"))
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh((2,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="freeze_bn"):
        model.train_bn("heads")


@pytest.mark.parametrize("driver", ["train.pretrain", "meta.train_driver"])
def test_training_drivers_without_device_need_cuda(monkeypatch, tmp_path,
                                                   driver):
    """The two training CLIs run on the card unless ``--device cpu``."""
    import importlib
    module = importlib.import_module(f"ood_object_detection_tpu_torch.{driver}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--checkpoint-dir", str(tmp_path)])


def test_deploy_cli_without_device_needs_cuda(monkeypatch):
    """The deploy CLI runs on the card unless ``--device cpu``."""
    from ood_object_detection_tpu_torch.examples import deploy_infer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy_infer.main(["--image-dir", str(ROOT / "tests" / "data" /
                                              "deploy_fixture")])


def test_importing_the_package_stays_light():
    """The top-level export names resolve lazily: importing the package
    loads no model, ops or export module."""
    code = ("import sys, ood_object_detection_tpu_torch as p\n"
            "heavy = [m for m in sys.modules if m.startswith("
            "('ood_object_detection_tpu_torch.models', "
            "'ood_object_detection_tpu_torch.ops', "
            "'ood_object_detection_tpu_torch.export'))]\n"
            "assert not heavy, heavy\n"
            "assert callable(p.export_predict)\n"
            "assert 'ood_object_detection_tpu_torch.export' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
