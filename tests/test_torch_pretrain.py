"""The port's ``train.pretrain`` CLI on the CPU at 128 px (one BiFPN cell,
one head repeat, 4 classes).

- The CLI smoke of ``tests/test_drivers.py:28-49`` at ``--mesh 1``: JSON
  train lines with finite losses, ``val_mAP``, the per-category dumps and
  the checkpoint files; then ``--resume`` continues from the saved step,
  and the checkpoint holds the state the run ended with, bit for bit.
- A ``--stream`` smoke (interleaved val blocks, ``--eval-map``).
- The refusal of ``--mesh 2`` (ROADMAP Queue 1 item 7).
- ``--dropout 0.2``, ``--remat 2`` and ``--remat-fpn-heads`` drive the CLI
  for 2 steps each: the flag reaches the model config as the JAX CLI puts
  it (``backbone_args`` ``drop_path_rate`` / ``remat_stages``,
  ``remat_fpn`` and ``remat_heads``), the losses are finite, and the two
  remat flags log the losses of the run without them.
- The driver-level parity: the same argv through the JAX
  ``pretrain.main`` (synthetic data, ``--mesh 1 --workers 0``) and the
  port's ``main`` started from the JAX initial state
  (``init_variables``, carried by ``utils.from_jax``). Every logged
  ``loss`` / ``class_loss`` / ``box_loss`` / ``val_loss`` agrees to rtol
  2e-4 (f32; the logs are rounded to 5 decimals; measured at most 2.5e-5),
  and ``num_positives`` exactly.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu_torch.config import (
    default_detection_train_config)
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.train import (CheckpointManager,
                                                  create_train_state)
from ood_object_detection_tpu_torch.train import pretrain

TINY = ["--num-classes", "4", "--image-size", "128", "--fpn-repeats", "1",
        "--head-repeats", "1", "--batch-size", "2", "--warmup-steps", "2",
        "--mesh", "1", "--workers", "0"]


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def _run(tmp_path, capsys, *extra, init_variables=None):
    result = pretrain.main(
        TINY + ["--device", "cpu", "--checkpoint-dir", str(tmp_path / "ck"),
                "--per-cat-dir", str(tmp_path / "pc"), *extra],
        init_variables=init_variables)
    out = capsys.readouterr().out
    return result, out, _json_lines(out)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    for name, x in a.ema_params.items():
        assert torch.equal(x, b.ema_params[name]), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for k, v in a.optimizer.state[p].items():
            assert torch.equal(v, b.optimizer.state[q][k])


def test_pretrain_cli_smoke_and_resume(tmp_path, capsys):
    state, _, logs = _run(
        tmp_path, capsys, "--steps", "6", "--val-freq", "3", "--val-steps",
        "1", "--log-freq", "2", "--eval-map")
    train_logs = [entry for entry in logs if "loss" in entry]
    assert len(train_logs) == 3
    assert all(np.isfinite(entry["loss"]) for entry in train_logs)
    assert [e["step"] for e in logs if "val_mAP" in e] == [3, 6]
    assert sorted(os.listdir(tmp_path / "pc")) == [
        f"test_{kind}_{s}.npy" for kind in ("ap", "corloc") for s in (3, 6)]
    assert np.load(tmp_path / "pc" / "test_ap_6.npy").shape == (4,)
    assert logs[-1]["final_step"] == 6 and state.step == 6
    ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert ckpt.latest_step() == 6

    # the checkpoint holds the state the run ended with
    model = create_model("efficientdet_d0", seed=5, device="cpu",
                         num_classes=4, image_size=(128, 128),
                         fpn_cell_repeats=1, box_class_repeats=1)
    fresh, _ = create_train_state(model, default_detection_train_config())
    _assert_states_equal(state, ckpt.restore(fresh))

    state, out, logs = _run(
        tmp_path, capsys, "--steps", "8", "--val-freq", "3", "--val-steps",
        "1", "--log-freq", "2", "--resume")
    assert "resumed from step 6" in out
    assert [e["step"] for e in logs if "loss" in e] == [8]
    assert logs[-1]["final_step"] == 8 and state.step == 8
    assert ckpt.all_steps() == [3, 6, 8]


def test_pretrain_stream_smoke(tmp_path, capsys):
    state, _, logs = _run(
        tmp_path, capsys, "--stream", "--steps", "4", "--val-freq", "2",
        "--val-steps", "1", "--log-freq", "2", "--eval-map")
    assert [e["step"] for e in logs if "loss" in e] == [2, 4]
    val = [e for e in logs if "val_loss" in e]
    assert val and all(np.isfinite(e["val_loss"]) for e in val)
    assert all("val_mAP" in e for e in val)
    assert state.step == 4 and logs[-1]["final_step"] == 4


@pytest.mark.parametrize("flags, item", [(["--mesh", "2"], "item 7")])
def test_unported_flags_raise(tmp_path, flags, item):
    argv = TINY + ["--device", "cpu", "--steps", "1",
                   "--checkpoint-dir", str(tmp_path / "ck")] + flags
    with pytest.raises(NotImplementedError, match=item):
        pretrain.main(argv)


_STEPS = ["--steps", "2", "--val-freq", "100", "--log-freq", "1"]


@pytest.fixture(scope="module")
def plain_losses(tmp_path_factory):
    """The logged losses of 2 plain steps (the remat runs must log them)."""
    tmp = tmp_path_factory.mktemp("plain")
    with torch.enable_grad():
        pretrain.main(TINY + _STEPS + [
            "--device", "cpu", "--checkpoint-dir", str(tmp / "ck"),
            "--per-cat-dir", str(tmp / "pc"), "--log-file",
            str(tmp / "log.jsonl")])
    with open(tmp / "log.jsonl") as f:
        return [json.loads(line)["loss"] for line in f if '"loss"' in line]


@pytest.mark.parametrize("flags, backbone_args, remat", [
    (["--dropout", "0.2"], {"drop_path_rate": 0.2}, False),
    (["--remat", "2"], {"remat_stages": 2}, False),
    (["--remat-fpn-heads"], {}, True)])
def test_model_flags_reach_the_model(tmp_path, capsys, plain_losses, flags,
                                     backbone_args, remat):
    state, _, logs = _run(tmp_path, capsys, *_STEPS, *flags)
    cfg = state.model.config
    assert cfg.backbone_args == backbone_args
    assert (cfg.remat_fpn, cfg.remat_heads) == (remat, remat)
    assert state.step == 2
    losses = [e["loss"] for e in logs if "loss" in e]
    assert len(losses) == 2 and all(np.isfinite(losses))
    if "--dropout" not in flags:
        assert losses == plain_losses


def test_pretrain_matches_the_jax_driver(tmp_path, capsys, monkeypatch):
    """Same argv, same initial state: the logged losses agree. The JAX
    driver's ``create_train_state`` initialises the model eagerly, op by
    op (about 50 s on the CPU); the test runs the same function under
    ``jax.jit`` in its place (one compile, the same ``key(0)`` draw) and
    hands the port the state it returned."""
    import jax

    from ood_object_detection_tpu.train import pretrain as jax_pretrain
    from ood_object_detection_tpu.train import train_state as jax_train_state

    eager = jax_train_state.create_train_state
    initial = []

    def jitted(model, tcfg, rng, lr_schedule=None, tx=None):
        tx = tx or jax_train_state.make_optimizer(tcfg, lr_schedule)
        state = jax.jit(lambda k: eager(model, tcfg, k, tx=tx)[0])(rng)
        initial.append(jax.device_get(state))    # the step donates it
        return state, tx
    monkeypatch.setattr(jax_train_state, "create_train_state", jitted)
    # the JAX driver sets jax's compile cache from this variable: keep
    # the test harness's cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR",
                       jax.config.jax_compilation_cache_dir or "")
    argv = TINY + ["--steps", "4", "--val-freq", "2", "--val-steps", "1",
                   "--log-freq", "2"]
    jax_pretrain.main(argv + [
        "--checkpoint-dir", str(tmp_path / "jck"),
        "--per-cat-dir", str(tmp_path / "jpc")])
    want = _json_lines(capsys.readouterr().out)
    assert len(initial) == 1
    _, _, got = _run(tmp_path, capsys, *argv[len(TINY):],
                     init_variables=initial[0])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["step" if "step" in g else "final_step"] == \
            w["step" if "step" in w else "final_step"]
        for k in ("loss", "class_loss", "box_loss", "val_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-4, err_msg=k)
        if "num_positives" in w:
            assert g["num_positives"] == w["num_positives"]
    assert sum("val_loss" in w for w in want) == 2


def test_every_jax_flag_is_accepted_with_its_default():
    """The port's parser has every option of the JAX CLI, with the same
    default; its one extra flag is ``--device``."""
    from ood_object_detection_tpu.train import pretrain as jax_pretrain

    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default)
                for a in parser._actions if a.option_strings
                and a.dest != "help"}
    want = options(jax_pretrain.build_argparser())
    got = options(pretrain.build_argparser())
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
