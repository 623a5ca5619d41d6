"""The measuring helpers of chip_smoke.py, on the CPU: the profiler
window's device busy time is the union of the device intervals, and
K1's bound counts the picks this run's data makes."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

_PATH = Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _event(start_us, end_us):
    return SimpleNamespace(time_range=SimpleNamespace(start=start_us,
                                                      end=end_us))


def test_busy_ms_is_the_union_of_device_intervals():
    # overlapping, nested, disjoint and touching intervals, out of order
    events = [_event(20, 30), _event(0, 10), _event(5, 15), _event(22, 25),
              _event(30, 31), _event(40, 40)]
    assert chip_smoke.busy_ms(events) == pytest.approx((15 + 11) / 1e3)
    assert chip_smoke.busy_ms([]) == 0.0


@pytest.mark.parametrize("picks, soft", [((3, 0), True), ((3, 0), False),
                                         ((100, 57), True)])
def test_nms_bound_counts_the_picks_made(picks, soft):
    n, max_out = 5000, 100
    keep = torch.full((len(picks), max_out), -1, dtype=torch.int32)
    for row, made in enumerate(picks):
        keep[row, :made] = torch.arange(made, dtype=torch.int32)
    # each image runs its picks and the one that finds nothing, at most
    # max_out in all
    iterations = sum(min(made + 1, max_out) for made in picks)
    ops = iterations * n * (20 if soft else 15)
    nbytes = len(picks) * (n * 20 + max_out * 8)
    t_ops = ops / (67e12 / 2)
    t_bytes = nbytes / 3.35e12
    bound_ms, by = chip_smoke.nms_bound_ms(keep, n, soft)
    assert bound_ms == pytest.approx(max(t_ops, t_bytes) * 1e3, rel=1e-12)
    assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_match_bound_counts_the_valid_pairs():
    """K3's bound: MATCH_OPS_PER_PAIR operations for each valid (row,
    anchor) pair of this run's data and MATCH_OPS_PER_MEET more for each
    one whose boxes meet, or its bytes, whichever is larger; and the flat
    yardstick, the sum of the two for every valid pair."""
    # anchor 2 overlaps anchor 0; anchor 3 touches it at a corner only
    anchors = torch.tensor([[0.0, 0.0, 10.0, 10.0], [20.0, 20.0, 30.0, 30.0],
                            [5.0, 5.0, 15.0, 15.0], [10.0, 10.0, 20.0, 20.0]])
    meets = torch.tensor([[0.0, 0.0, 10.0, 10.0]])
    far = torch.tensor([[100.0, 100.0, 110.0, 110.0]])
    # image 0: row 0 meets anchors 0 and 2, the other rows meet none and
    # the last is padding; image 1 is all padding
    for rows in (2, 50):
        gt = torch.cat([meets, far.repeat(rows - 1, 1), meets])
        gt = gt[None].repeat(2, 1, 1)
        valid = torch.zeros((2, rows + 1), dtype=torch.bool)
        valid[0, :rows] = True
        assert chip_smoke.meeting_pairs(anchors, gt, valid) == 2
        for tile in (1, 200_000):
            a = 4 * tile
            t_ops = (rows * a * chip_smoke.MATCH_OPS_PER_PAIR
                     + 2 * tile * chip_smoke.MATCH_OPS_PER_MEET) / (67e12 / 2)
            t_bytes = (a * 16 + 2 * (rows + 1) * 21 + 2 * a * 8) / 3.35e12
            every = rows * a * 17 / (67e12 / 2)
            bound_ms, by, every_ms = chip_smoke.match_bound_ms(
                anchors.repeat(tile, 1), gt, valid)
            assert bound_ms == pytest.approx(max(t_ops, t_bytes) * 1e3,
                                             rel=1e-12)
            assert by == ("bytes" if t_bytes >= t_ops else "operations")
            assert every_ms == pytest.approx(every * 1e3, rel=1e-12)
            if tile > 1:
                assert by == ("operations" if rows == 50 else "bytes")


def test_targets_bound_counts_bytes_and_positives():
    """K4's bound: K3's value and row in and code, class and box out an
    anchor (32 B), the anchors and the rows once; or 4 operations an
    anchor and 20 a positive of this run's codes."""
    codes = torch.full((2, 1000), -1, dtype=torch.int32)
    codes[0, :30] = 3
    t_bytes = (2 * 1000 * 32 + 1000 * 16 + 2 * 100 * 25) / 3.35e12
    t_ops = (2 * 1000 * 4 + 30 * 20) / (67e12 / 2)
    bound_ms, by = chip_smoke.targets_bound_ms(codes, 100)
    assert bound_ms == pytest.approx(max(t_bytes, t_ops) * 1e3, rel=1e-12)
    assert by == "bytes"


def test_meta_path_drive_runs_on_the_cpu():
    """Phase 8's drive (meta_setup + meta_path) on the CPU at 128 px with a
    one-cell, one-repeat D0, meta batches of 2 and 2 + 4 episodes: every
    check of the phase that does not need the card passes (finite
    metrics, a meta step every 2nd episode, the class head and
    ProjectionNet moving, the inner LRs, trunk and BatchNorm statistics
    not, detection and OOD shapes); the plain versions launch nothing."""
    meta = chip_smoke.MetaConfig(num_sup=2, num_qry=3, num_zero_images=1,
                                 img_size=128, qry_img_size=128,
                                 meta_batch_size=2)
    gen = torch.Generator().manual_seed(0)
    with torch.enable_grad():
        trainer, builder, colors = chip_smoke.meta_setup(
            gen, device="cpu", meta_cfg=meta, fpn_cell_repeats=1,
            box_class_repeats=1)
        batches, launches, dets = chip_smoke.meta_path(
            trainer, builder, colors, gen, episodes=(2, 4))
    assert len(batches) == 6 and tuple(dets.shape) == (4, 30, 6)
    assert set(launches.values()) == {0}
    # the zero image has no ground truth; the projection crops carry the
    # task class (0-based) among their anchor labels
    assert not bool((batches[0]["qry_gt_cls"][-1] > 0).any())
    assert bool((batches[0]["proj_cls"] == batches[0]["task_cls"]).any())
