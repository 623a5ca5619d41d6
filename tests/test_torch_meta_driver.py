"""The port's ``meta.train_driver`` CLI on the CPU at 128 px (one BiFPN
cell, one head repeat).

- The CLI smoke of ``tests/test_drivers.py:53-80``: the final iteration,
  both phases logged, a checkpoint, ``ood_auroc_gt`` a float in [0, 1];
  the checkpoint's ``meta_params`` load back into a fresh trainer's bit
  for bit.
- ``--coco-ann`` on the tiny COCO fixture of
  ``tests/test_meta_real_data.py``, with and without ``--support-dir``.
- ``--episode-mesh 2`` raises (ROADMAP Queue 1 item 7).
- ``--load-ckpt`` from a port variables file, and with
  ``--separate-head`` from a file without the separate head (the fresh
  head is kept).
- Phase-A parity: the same argv through the JAX ``train_driver.main`` and
  the port's ``main`` from the JAX initial weights (``init_variables``:
  the JAX model's ``key(0)`` variables and the ProjectionNet's ``key(1)``
  parameters, carried by ``utils.from_jax``), both given the same
  variables with calibrated running statistics through ``--load-ckpt``
  (an orbax file for JAX, a port file for the port), and the global
  ``random`` that jitters the projection crops seeded alike: the
  episodes are the same, and each logged ``proj_loss`` (two episodes, a
  meta step between them) agrees to rtol 1e-4 (measured at most 3.2e-6
  on the 5-decimal logs), ``valid_champions`` exactly.
"""
import json
import os
import random

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from test_meta_real_data import _write_coco_fixture, _write_support_dir

from ood_object_detection_tpu_torch.meta import train_driver
from ood_object_detection_tpu_torch.train import (CheckpointManager,
                                                  save_variables)

TINY = ["--img-size", "128", "--qry-img-size", "128", "--fpn-repeats", "1",
        "--head-repeats", "1"]


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def _run(tmp_path, capsys, *extra, init_variables=None):
    trainer = train_driver.main(
        TINY + ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                "--per-cat-dir", str(tmp_path / "pc"), *extra],
        init_variables=init_variables)
    return trainer, _json_lines(capsys.readouterr().out)


def test_meta_cli_smoke(tmp_path, capsys):
    trainer, logs = _run(
        tmp_path, capsys, "--n-way", "2", "--num-sup", "2", "--num-qry", "2",
        "--num-zero-images", "1", "--meta-batch-size", "1",
        "--proj-iters", "2", "--total-iters", "6", "--val-freq", "3",
        "--log-freq", "2", "--synthetic-cats", "4", "--eval-map",
        "--eval-ood")
    assert logs and logs[-1]["final_iter"] == 6
    phases = {entry.get("phase") for entry in logs if "phase" in entry}
    assert phases == {"proj", "maml"}
    ood = [entry for entry in logs if "ood_auroc_gt" in entry]
    assert ood and all(isinstance(e["ood_auroc_gt"], float)
                       and 0.0 <= e["ood_auroc_gt"] <= 1.0 for e in ood)
    assert list((tmp_path / "pc").glob("meta_ap_*.npy"))
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() == 6

    # the saved meta parameters load back into a fresh trainer bit for bit
    fresh, _ = _run(tmp_path / "fresh", capsys, "--n-way", "2",
                    "--num-sup", "2", "--num-qry", "2",
                    "--num-zero-images", "1", "--total-iters", "0",
                    "--synthetic-cats", "4")
    ckpt.restore(fresh.meta_params)
    for tree, leaves in trainer.meta_params.items():
        for name, value in leaves.items():
            assert torch.equal(fresh.meta_params[tree][name], value), name


@pytest.mark.parametrize("support_dir", [False, True])
def test_meta_cli_real_data(tmp_path, capsys, support_dir):
    ann, img_dir = _write_coco_fixture(str(tmp_path))
    extra = ["--support-dir", _write_support_dir(str(tmp_path))] \
        if support_dir else []
    _, logs = _run(
        tmp_path, capsys, "--n-way", "1", "--num-sup", "2", "--num-qry", "2",
        "--num-zero-images", "1", "--meta-batch-size", "1",
        "--proj-iters", "2", "--total-iters", "8", "--val-freq", "4",
        "--log-freq", "2", "--coco-ann", ann, "--data-dir", img_dir,
        "--num-train-cats", "2", "--num-val-cats", "1", "--eval-map",
        *extra)
    assert logs[-1]["final_iter"] == 8
    assert {e.get("phase") for e in logs if "phase" in e} == {"proj", "maml"}
    for entry in logs:
        for k, v in entry.items():
            if isinstance(v, float):
                assert np.isfinite(v), (k, v)
    assert any("val_mAP" in e for e in logs)
    assert os.listdir(tmp_path / "ck")


def test_episode_mesh_raises(tmp_path):
    """--episode-mesh 2 outside a launch of two processes raises and names
    torchrun (tests/test_torch_parallel_meta.py runs it launched)."""
    with pytest.raises(ValueError, match="torchrun"):
        train_driver.main(TINY + ["--device", "cpu", "--episode-mesh", "2",
                                  "--checkpoint-dir", str(tmp_path)])


def _model(separate_head, seed):
    from ood_object_detection_tpu_torch.factory import create_model
    return create_model("efficientdet_d0", num_classes=1, seed=seed,
                        device="cpu", image_size=(128, 128),
                        fpn_cell_repeats=1, box_class_repeats=1,
                        separate_head=separate_head)


@pytest.mark.parametrize("separate_head", [False, True])
def test_load_ckpt(tmp_path, capsys, separate_head):
    """A variables file of a model without the separate head loads into
    the driver's model; with ``--separate-head`` the head it lacks keeps
    its seeded values. A file of another shape raises."""
    src = _model(False, seed=3)
    path = str(tmp_path / "vars.pt")
    save_variables(path, src.state_dict())
    flags = ["--separate-head"] if separate_head else []
    trainer, _ = _run(tmp_path, capsys, "--num-sup", "2", "--num-qry", "2",
                      "--num-zero-images", "1", "--total-iters", "0",
                      "--synthetic-cats", "4", "--load-ckpt", path, *flags)
    got = trainer.model.state_dict()
    for name, value in src.state_dict().items():
        assert torch.equal(got[name], value), name
    if separate_head:
        fresh = _model(True, seed=0).state_dict()
        sep = [k for k in got if k.startswith("class_net.predict_sep.")]
        assert sep and all(torch.equal(got[k], fresh[k]) for k in sep)
    other = str(tmp_path / "other.pt")
    save_variables(other, _model(False, seed=3).class_net.state_dict())
    with pytest.raises(ValueError):
        _run(tmp_path, capsys, "--total-iters", "0", "--load-ckpt", other,
             *flags)


def test_phase_a_matches_the_jax_driver(tmp_path, capsys):
    import jax
    import jax.numpy as jnp
    from torch_meta_helpers import calibrate_batch_stats

    from ood_object_detection_tpu.config import (
        get_efficientdet_config as jax_cfg)
    from ood_object_detection_tpu.data.episodic import (
        EpisodicDataset as JaxEpisodes)
    from ood_object_detection_tpu.data.episodic import (
        SyntheticEpisodeSource as JaxSource)
    from ood_object_detection_tpu.meta import MetaConfig as JaxMeta
    from ood_object_detection_tpu.meta import ProjectionNet as JaxProjection
    from ood_object_detection_tpu.meta import train_driver as jax_driver
    from ood_object_detection_tpu.meta.projection import POS_DIM
    from ood_object_detection_tpu.models import EfficientDet as JaxDet
    from ood_object_detection_tpu.train.checkpoint import (
        save_variables as jax_save_variables)
    from ood_object_detection_tpu_torch.utils.from_jax import (
        load_jax_variables)

    # the JAX driver's initial weights (meta/train_driver.py:201-232)
    cfg = jax_cfg("efficientdet_d0", num_classes=1,
                  image_size=(128, 128)).replace(fpn_cell_repeats=1,
                                                 box_class_repeats=1)
    model = JaxDet(cfg)
    variables = jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 128, 128, 3)), training=False))(jax.random.key(0))
    proj = JaxProjection(fpn_channels=cfg.fpn_channels, width=512, depth=2)
    proj_params = dict(proj.init(jax.random.key(1), jnp.zeros(
        (1, cfg.fpn_channels + POS_DIM)))["params"])
    proj_params["dot_mult"] = jnp.float32(3.0)
    proj_params["dot_add"] = jnp.float32(3.0)

    # running statistics calibrated on the driver's first episode, given
    # to both drivers through --load-ckpt (tests/torch_meta_helpers.py:
    # an untrained trunk's pyramid barely depends on the image, and the
    # champions' validity then comes down to each framework's rounding)
    meta = dict(num_sup=2, num_qry=3, num_zero_images=1, img_size=128,
                qry_img_size=128)
    src = JaxSource(num_cats=4, img_hw=(128, 128))
    random.seed(0)
    first = next(iter(JaxEpisodes(
        src.support_source([1, 2, 3, 4]), src, cfg, JaxMeta(**meta),
        train_cats=[1, 2], val_cats=[3, 4])))
    calibrated = calibrate_batch_stats(model, variables, jnp.concatenate(
        [first[k] for k in ("supp_images", "qry_images", "proj_images")]))
    jax_ckpt = str(tmp_path / "jax_vars")
    jax_save_variables(jax_ckpt, calibrated)
    port_model = _model(False, seed=0)
    load_jax_variables(port_model, calibrated)
    port_ckpt = str(tmp_path / "port_vars.pt")
    save_variables(port_ckpt, port_model.state_dict())

    argv = TINY + ["--num-sup", "2", "--num-qry", "3", "--num-zero-images",
                   "1", "--meta-batch-size", "1", "--proj-iters", "2",
                   "--total-iters", "2", "--log-freq", "1",
                   "--synthetic-cats", "4"]
    random.seed(0)
    jax_driver.main(argv + ["--load-ckpt", jax_ckpt,
                            "--checkpoint-dir", str(tmp_path / "jck"),
                            "--per-cat-dir", str(tmp_path / "jpc")])
    want = _json_lines(capsys.readouterr().out)
    random.seed(0)
    _, got = _run(tmp_path, capsys, *argv[len(TINY):], "--load-ckpt",
                  port_ckpt, init_variables={"variables": variables,
                                             "proj_params": proj_params})

    want = [e for e in want if "proj_loss" in e]
    got = [e for e in got if "proj_loss" in e]
    assert [e["iter"] for e in got] == [e["iter"] for e in want] == [1, 2]
    for g, w in zip(got, want):
        assert g["phase"] == w["phase"] == "proj"
        np.testing.assert_allclose(g["proj_loss"], w["proj_loss"], rtol=1e-4)
        assert g["valid_champions"] == w["valid_champions"]


def test_every_jax_flag_is_accepted_with_its_default():
    """The port's parser has every option of the JAX CLI, with the same
    default; its extra flags are ``--device`` and ``--dist-backend``,
    which say where the run goes."""
    from ood_object_detection_tpu.meta import train_driver as jax_driver

    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions if a.option_strings
                and a.dest != "help"}
    want = options(jax_driver.build_argparser())
    got = options(train_driver.build_argparser())
    assert set(got) - set(want) == {"device", "dist_backend"}
    assert {k: got[k] for k in want} == want
