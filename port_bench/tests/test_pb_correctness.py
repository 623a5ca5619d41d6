"""What decides ``correct``, at a size the CPU holds: a sound run passes;
the control (the reference in float8 put in the program's place) and each
fault a cell can have, planted underneath the timed path, do not."""
import pytest
import torch

from port_bench.drivers import predict, train
from port_bench.tests.small import line, make_run

PREDICT, TRAIN = "d0_predict_b128", "d0_train_b128"


@pytest.mark.parametrize("cell", [PREDICT, TRAIN])
def test_a_sound_run_is_correct(cell, capsys):
    out = line(cell, capsys)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0


def test_the_predict_control_is_not_correct():
    run = make_run(PREDICT)
    s = predict.Setup(run)
    verdict = predict.judge(s, predict.control(s, [0, 1]))["checks"]
    assert any(verdict[k] > run.limits[k] for k in predict.CHECKS), verdict


def test_the_train_control_is_not_correct():
    run = make_run(TRAIN)
    s = train.Setup(run)
    ref = train.reference_steps(s.ref, s.cfg, s.tcfg, s.state, s.pool, 3,
                                s.device)
    low = train.reference_steps(s.ref, s.cfg, s.tcfg, s.state, s.pool, 3,
                                s.device, prec="fp8")
    gaps = train.compare(low, ref)
    assert any(gaps[k] > run.limits[k] for k in train.CHECKS), gaps


def _broken_predict(monkeypatch, fault):
    from ood_object_detection_tpu_torch.bench import DetBenchPredict
    forward = DetBenchPredict.forward_with_ood

    def broken(self, x, img_info=None):
        dets, ood = forward(self, x, img_info)
        return fault(dets.clone(), ood.clone())
    monkeypatch.setattr(DetBenchPredict, "forward_with_ood", broken)


def _half(dets, ood):                    # half of the batch left out
    dets[dets.shape[0] // 2:] = 0
    ood[ood.shape[0] // 2:] = 0
    return dets, ood


def _altered(dets, ood):                 # one answer altered where made
    dets[0, 0, [0, 2]] += (dets[0, 0, 2] - dets[0, 0, 0]).clamp(min=1.0)
    ood[0, 0] += 1.0
    return dets, ood


def _class_shift(dets, ood):             # class ids one higher
    dets[..., 5] = torch.where(dets[..., 4] > 0, dets[..., 5] + 1,
                               dets[..., 5])
    return dets, ood


def _rescored(dets, ood):                # every score a tenth high
    dets[..., 4] *= 1.1
    return dets, ood


@pytest.mark.parametrize("fault", [_half, _altered, _class_shift, _rescored])
def test_a_broken_predict_path_is_not_correct(fault, monkeypatch, capsys):
    _broken_predict(monkeypatch, fault)
    out = line(PREDICT, capsys)
    assert not out["correct"], out["checks"]


def test_hard_nms_in_place_of_soft_nms_is_not_correct(capsys):
    """The program's own hard-NMS path (K1 with ``soft_nms`` false) where
    the configuration states soft-NMS."""
    out = line(PREDICT, capsys, model={"soft_nms": False})
    assert not out["correct"], out["checks"]
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed & {"pick_gap_mean", "score_err_mean"}, out["checks"]


def _broken_step(monkeypatch, wrap):
    import ood_object_detection_tpu_torch.train as port_train
    make = port_train.make_train_step

    def make_broken(*args, **kwargs):
        return wrap(make(*args, **kwargs))
    monkeypatch.setattr(port_train, "make_train_step", make_broken)


def _unchanged(step):                    # the state comes back unchanged
    def broken(state, batch):
        return state, {"loss": torch.tensor(1.0)}
    return broken


def _half_batch(step):                   # the mean over half of the batch
    def broken(state, batch):
        half = batch["image"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
    return broken


@pytest.mark.parametrize("wrap", [_unchanged, _half_batch])
def test_a_broken_train_step_is_not_correct(wrap, monkeypatch, capsys):
    _broken_step(monkeypatch, wrap)
    assert not line(TRAIN, capsys)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", [PREDICT, TRAIN, "d4_predict_b16"])
def test_each_cell_is_correct_on_the_card(cell, card, capsys):
    """A short run of each cell at its full size on the card."""
    from port_bench import run as bench_run
    import json
    assert bench_run.main(["--workload", cell, "--seed", "2147483999",
                           "--seconds", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
