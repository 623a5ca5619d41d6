"""``train.checkpoint`` of the port: torch files in place of orbax.

A ``TrainState`` after two SGD steps (so the momentum buffers and EMA are
not at their start) saves and restores bit-equal into a fresh state:
parameters, BatchNorm statistics, EMA, optimizer state and step, and the
next step from the restored state equals the next step from the
original. ``keep`` prunes to the newest steps, ``latest_step`` reads the
directory, a left-over temporary file of an unfinished save is ignored,
a save at a step already saved is skipped (orbax's rule), metrics are
stored, nested dicts of tensors (the meta driver's parameters) round-trip
in place, and ``save_variables`` / ``restore_variables`` round-trip and
refuse other keys or shapes. All on the CPU, at the tiny D0 of the train
step tests (128 px, one BiFPN cell, one head repeat)."""
import os

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu_torch.config import (
    default_detection_train_config)
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (
    CheckpointManager, create_train_state, linear_schedule, make_train_step,
    restore_variables, save_variables)

TINY = dict(num_classes=4, image_size=(128, 128), fpn_cell_repeats=1,
            box_class_repeats=1)


def _batch(seed):
    rng = np.random.default_rng(seed)
    boxes = np.full((2, 8, 4), -1, np.float32)
    cls = np.full((2, 8), -1, np.int32)
    boxes[:, :3] = [[10, 12, 60, 70], [40, 30, 100, 90], [70, 80, 120, 126]]
    cls[:, :3] = rng.integers(1, 5, (2, 3))
    return {"image": torch.from_numpy(rng.normal(0, 1, (2, 128, 128, 3))
                                      .astype(np.float32)),
            "bbox": torch.from_numpy(boxes), "cls": torch.from_numpy(cls)}


def _state(seed=0):
    model = create_model("efficientdet_d0", seed=seed, device="cpu", **TINY)
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg,
                                   lr_schedule=linear_schedule(1e-4, 0.09, 3))
    step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                           freeze_bn="none")
    return state, step


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (na, ta), (nb, tb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert na == nb and torch.equal(ta, tb), na
    for name, t in a.ema_params.items():
        assert torch.equal(t, b.ema_params[name]), name
    pa = list(a.model.parameters())
    pb = list(b.model.parameters())
    for x, y in zip(pa, pb):
        sa, sb = a.optimizer.state[x], b.optimizer.state[y]
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k])
    for ga, gb in zip(a.optimizer.param_groups, b.optimizer.param_groups):
        assert ga["lr"] == gb["lr"] and gb["lr_schedule"] is not None


def test_train_state_round_trip_is_bit_equal(tmp_path):
    state, step = _state()
    for seed in (1, 2):
        state, _ = step(state, _batch(seed))
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    assert ckpt.save(2, state, metrics={"val_loss": 1.5})
    fresh, fresh_step = _state(seed=9)
    assert fresh.step == 0
    restored = ckpt.restore(fresh)
    assert restored is fresh
    _assert_states_equal(state, fresh)
    # the step and the schedule continue from the restored state
    state, m1 = step(state, _batch(3))
    fresh, m2 = fresh_step(fresh, _batch(3))
    assert fresh.step == 3
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_states_equal(state, fresh)
    assert ckpt.metrics(2) == {"val_loss": 1.5}


def test_keep_prunes_and_latest_step(tmp_path):
    ckpt = CheckpointManager(str(tmp_path / "c"), keep=3)
    assert ckpt.latest_step() is None
    tree = {"a": {"w": torch.zeros(3)}}
    for step in (1, 2, 5, 7, 9):
        tree["a"]["w"].fill_(step)
        assert ckpt.save(step, tree)
    assert ckpt.all_steps() == [5, 7, 9] and ckpt.latest_step() == 9
    assert sorted(os.listdir(ckpt.directory)) == [
        "step_5.pt", "step_7.pt", "step_9.pt"]
    # a step at or below the latest is skipped, as orbax's manager does
    assert not ckpt.save(9, tree) and not ckpt.save(4, tree)
    # a temporary file of a save that was killed is not a step
    (tmp_path / "c" / "step_11.pt.tmp-123").write_bytes(b"partial")
    assert ckpt.latest_step() == 9
    like = {"a": {"w": torch.zeros(3)}}
    ckpt.restore(like)
    assert torch.equal(like["a"]["w"], torch.full((3,), 9.0))
    ckpt.restore(like, step=5)
    assert torch.equal(like["a"]["w"], torch.full((3,), 5.0))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(like)


def test_nested_parameters_restore_in_place(tmp_path):
    """The meta driver's ``meta_params``: dicts of parameters (which
    require grad) restored into a fresh tree's tensors in place."""
    net = torch.nn.Linear(3, 2)
    tree = {"proj": dict(net.named_parameters()),
            "inner_lrs": {"lr": torch.tensor(0.1, requires_grad=True)}}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, tree)
    fresh = torch.nn.Linear(3, 2)
    like = {"proj": dict(fresh.named_parameters()),
            "inner_lrs": {"lr": torch.tensor(0.5, requires_grad=True)}}
    ckpt.restore(like)
    assert torch.equal(fresh.weight, net.weight)
    assert torch.equal(fresh.bias, net.bias)
    assert float(like["inner_lrs"]["lr"].detach()) == pytest.approx(0.1)
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore({"proj": like["proj"]})


def test_save_restore_variables(tmp_path):
    model = create_model("efficientdet_d0", seed=3, device="cpu", **TINY)
    path = str(tmp_path / "vars.pt")
    save_variables(path, model.state_dict())
    other = create_model("efficientdet_d0", seed=4, device="cpu", **TINY)
    restored = restore_variables(path, other.state_dict())
    other.load_state_dict(restored)
    for (n, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), n
    wider = create_model("efficientdet_d0", seed=3, device="cpu",
                         **{**TINY, "num_classes": 5})
    with pytest.raises(ValueError, match="shape"):
        restore_variables(path, wider.state_dict())
    with pytest.raises(ValueError, match="keys"):
        restore_variables(path, {"x": torch.zeros(1)})
