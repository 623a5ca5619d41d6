"""The measuring helpers of chip_smoke.py, on the CPU: the profiler
window's device busy time is the union of the device intervals, and
K1's bound counts the picks this run's data makes; and the drives of its
meta (phase 8) and validate (phase 9) paths on the CPU at 128 px."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
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


def test_trace_idle_reads_the_annotated_window(tmp_path):
    """The idle share of phase 10's trace: the wall from the first
    train_step annotation's start to the last one's end, the busy time the
    union of the card's kernel / copy / set intervals clipped to it."""
    events = [
        {"name": "train_step", "cat": "user_annotation", "ts": 100, "dur": 40},
        {"name": "train_step", "cat": "user_annotation", "ts": 150, "dur": 50},
        {"name": "k", "cat": "kernel", "ts": 90, "dur": 20},       # 10 in
        {"name": "k", "cat": "kernel", "ts": 120, "dur": 10},
        {"name": "c", "cat": "gpu_memcpy", "ts": 125, "dur": 10},  # 5 new
        {"name": "s", "cat": "gpu_memset", "ts": 190, "dur": 30},  # 10 in
        {"name": "k", "cat": "kernel", "ts": 300, "dur": 5},       # outside
        {"name": "op", "cat": "cpu_op", "ts": 100, "dur": 100}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    wall, busy, idle, in_steps = chip_smoke.trace_idle(str(path))
    assert wall == pytest.approx(0.1) and busy == pytest.approx(0.035)
    assert idle == pytest.approx(0.65) and in_steps == pytest.approx(0.09)


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


def test_validate_path_drive_runs_on_the_cpu(tmp_path):
    """Phase 9's drive (validate_path) on the CPU at 128 px, batch 2, over
    its own COCO-layout fixture of 5 images and its reference-named .pth:
    every check of the phase that does not need the card passes (61 of 61
    images there, 5 of 5 here, the partial last batch included; finite
    metrics; kernel and plain paths alike; exact and approx; the ground
    truth at AP 1.0); the .pth loads strictly; the plain versions launch
    nothing."""
    from ood_object_detection_tpu_torch.data.parsers import CocoParser
    from ood_object_detection_tpu_torch.utils.checkpoint_convert import (
        load_pytorch_checkpoint)
    root, pth = str(tmp_path / "coco"), str(tmp_path / "d0.pth")
    chip_smoke.write_coco_fixture(root, n=5)
    chip_smoke.write_reference_pth(pth)
    parser = CocoParser(f"{root}/annotations/instances_val2017.json")
    assert len(parser) == 5 and parser.max_label == 3
    assert {(i["height"], i["width"]) for i in parser.img_infos} == set(
        chip_smoke.COCO_SIZES)
    model = chip_smoke.create_model("efficientdet_d0", num_classes=90,
                                    device="cpu")
    report = load_pytorch_checkpoint(pth, model, strict=True)
    assert len(report["loaded"]) == len(model.state_dict()) - sum(
        k.endswith("num_batches_tracked") for k in model.state_dict())
    bias = model.class_net.predict_bias().detach()
    assert float(bias[0]) > float(bias[3]) + 1.9     # classes 1-3 raised
    with torch.no_grad():
        metrics, launches, _, batches, times = chip_smoke.validate_path(
            root, pth, device="cpu", image_size=128, batch=2)
    assert metrics["images"] == 5 and times["batches"] == 3
    assert [b["image"].shape[0] for b in batches] == [2, 2, 1]
    assert set(launches.values()) == {0}


def test_pretrain_path_drive_runs_on_the_cpu(tmp_path):
    """Phase 10's drive (pretrain_path) on the CPU at 128 px with a
    one-cell, one-repeat D0, 4 classes, batch 2, 4 steps validating every
    2nd: every check of the phase that does not need the card passes
    (finite logged losses, val_mAP at each validation, the per-category
    dumps, the checkpoint restoring the final state bit for bit,
    --resume continuing from step 4, the --stream run's steps and val
    blocks); the plain versions launch nothing."""
    tiny = ["--num-classes", "4", "--image-size", "128", "--fpn-repeats",
            "1", "--head-repeats", "1", "--batch-size", "2", "--workers",
            "1", "--log-freq", "2", "--warmup-steps", "2"]
    with torch.enable_grad():
        state, logs, timer, launches, trace = chip_smoke.pretrain_path(
            str(tmp_path), device="cpu", steps=4, val_freq=2, extra=tiny)
    assert state.step == 4 and len(timer.times) == 4 and trace is None
    assert [e["step"] for e in logs if "val_mAP" in e] == [2, 4]
    assert {k: set(v.values()) for k, v in launches.items()} == {
        "run": {0}, "resume": {0}, "stream": {0}}


def test_meta_driver_path_drive_runs_on_the_cpu(tmp_path):
    """Phase 11's drive (meta_driver_path) on the CPU at 128 px with a
    one-cell, one-repeat D0, 2 supports, 2 + 1 queries: every check of the
    phase that does not need the card passes (both phases logged,
    final_iter 12, ood_auroc_gt in [0, 1], finite metrics, the saved
    meta_params loading into a fresh trainer bit for bit); the plain
    versions launch nothing."""
    tiny = ["--img-size", "128", "--qry-img-size", "128", "--fpn-repeats",
            "1", "--head-repeats", "1", "--num-sup", "2", "--num-qry", "2",
            "--num-zero-images", "1"]
    with torch.enable_grad():
        trainer, logs, launches, episode = chip_smoke.meta_driver_path(
            str(tmp_path), device="cpu", extra=tiny)
    assert logs[-1]["final_iter"] == 12 and set(launches.values()) == {0}
    assert tuple(episode["qry_images"].shape) == (3, 128, 128, 3)


def test_meta_driver_rate_drive_runs_on_the_cpu(tmp_path):
    """Phase 11's training-rate drive (meta_driver_rate) on the CPU at the
    same tiny size: 4 phase-A and 8 phase-B iterations, every one a
    training episode (no validation block logged)."""
    tiny = ["--img-size", "128", "--qry-img-size", "128", "--fpn-repeats",
            "1", "--head-repeats", "1", "--num-sup", "2", "--num-qry", "2",
            "--num-zero-images", "1"]
    with torch.enable_grad():
        logs = chip_smoke.meta_driver_rate(str(tmp_path), device="cpu",
                                           extra=tiny)
    assert [e["iter"] for e in logs if "eps_per_sec" in e] == [4, 8, 12]
    assert all(e["eps_per_sec"] > 0 for e in logs if "eps_per_sec" in e)
    assert logs[-1]["final_iter"] == 12


def test_serving_path_drive_runs_on_the_cpu(tmp_path):
    """Phase 12's drives on the CPU: D0 at 128 px exported once with the
    letterbox inside and a symbolic batch, saved, loaded with
    ``device="cpu"`` and served at batches 1 and 3, equal to the live path
    (serving_path); the artifact loaded again onto the CPU
    (artifact_on_cpu); the deploy CLI with the golden fixture's weights
    rebuilt in the port (deploy_weights) on the five JPEGs and over one
    copy of them, and the model's head outputs against its run with the
    conv sums in f64 (deploy_path). The plain versions launch nothing."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        # the first energy reduce of a CPU process can round differently
        # from the later ones (tests/test_torch_export.py); serving_path
        # holds the artifact to the live path bit for bit, so a throwaway
        # forward comes first
        chip_smoke.live_serving(chip_smoke.serving_bench("cpu", 128),
                                *chip_smoke.serving_inputs(1, gen, 128, "cpu"))
        bench, module, path, seconds, launches = chip_smoke.serving_path(
            str(tmp_path), gen, device="cpu", img=128, batches=(1, 3))
        chip_smoke.artifact_on_cpu(path, gen, img=128)
        summary, rate = chip_smoke.deploy_path(str(tmp_path), device="cpu",
                                               copies=1)
    assert set(seconds) == {"export", "save", "load", "MB"}
    assert all(set(v.values()) == {0} for v in launches.values())
    assert summary["images"] == 5 and summary["device"] == "cpu"
    assert summary["decoder"] in ("native", "pil") and rate > 0


def test_deploy_rows_match_holds_the_golden_tolerances():
    """The deploy comparison of phase 12: a row moved by 2 px, 0.01 in
    score and 0.1 in OOD still matches; 4 px, another class or a count off
    by 13 does not."""
    row = {"box_xyxy": [10.0, 20.0, 50.0, 80.0], "score": 0.5, "class": 3,
           "ood_score": 1.0}
    near = dict(row, box_xyxy=[12.0, 18.0, 52.0, 78.0], score=0.51,
                ood_score=1.1)
    ref = [{"path": "a/x.jpg", "detections": [row]}]
    assert chip_smoke.deploy_rows_match(
        ref, [{"path": "b/x.jpg", "detections": [near]}]) == []
    for bad in (dict(near, box_xyxy=[14.0, 20.0, 50.0, 80.0]),
                dict(near, **{"class": 4})):
        assert len(chip_smoke.deploy_rows_match(
            ref, [{"path": "x.jpg", "detections": [bad]}])) == 1
    many = [{"path": "x.jpg", "detections": [near] * 14}]
    assert chip_smoke.deploy_rows_match(ref, many) == [
        ("x.jpg", "count", 1, 14)]


def test_deploy_scores_match_holds_what_the_fixture_determines():
    """Phase 12's deploy comparison: the top rows' scores and OOD scores,
    each sorted, within 0.02 and 0.2 and the counts within 12 pass, wherever
    the boxes and classes went; a top score 0.03 off, an OOD score 0.3
    beyond the others' or a count off by 13 does not."""
    rows = [{"box_xyxy": [10.0 * i, 0.0, 10.0 * i + 5, 5.0],
             "score": 0.5 - 0.01 * i, "class": 3, "ood_score": 1.0 + 0.1 * i}
            for i in range(12)]
    moved = [dict(r, box_xyxy=[0.0, 0.0, 1.0, 1.0], **{"class": 4},
                  score=r["score"] + 0.015) for r in reversed(rows)]
    ref = [{"path": "a/x.jpg", "detections": rows}]
    assert chip_smoke.deploy_scores_match(
        ref, [{"path": "b/x.jpg", "detections": moved}]) == []
    for bad in ([dict(rows[0], score=0.53)] + rows[1:],
                [dict(rows[0], ood_score=2.2)] + rows[1:],
                rows + rows[:1] * 13):
        assert len(chip_smoke.deploy_scores_match(
            ref, [{"path": "x.jpg", "detections": bad}])) == 1


def test_head_gap_reads_mean_and_share():
    a = [np.zeros((2, 3), np.float32), np.ones(4, np.float32)]
    b = [np.zeros((2, 3), np.float32), np.array([1, 1, 1, 3], np.float32)]
    assert chip_smoke.head_gap(a, b) == pytest.approx((0.2, 0.1))
    assert chip_smoke.head_gap(a, a) == (0.0, 0.0)


def test_breadth_predict_drive_runs_on_the_cpu():
    """Phase 13 (a)'s drive (breadth_predict) on the CPU at 128 px, batch
    2: CSPResDet-50 at full width, bf16, three requests through the
    letterbox, the forward and the post-process, finite outputs of their
    shapes with detections, the plain path on the last batch equal to the
    kernel path's (their plain versions here); nothing launches."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        bench, (cls, _, cand, _, _, _), launches = \
            chip_smoke.breadth_predict(gen, device="cpu", img=128, batch=2)
    assert bench.model.config.name == chip_smoke.BREADTH_MODEL
    assert bench.model.config.upsample_type == "bilinear"
    assert cls[0].dtype == torch.bfloat16 and len(cls) == 5
    assert tuple(cand.ood_all.shape) == (2, bench.anchors.boxes.shape[0])
    assert set(launches.values()) == {0}


def test_breadth_pretrain_drive_runs_on_the_cpu(tmp_path):
    """Phase 13 (b)'s drive (breadth_pretrain) on the CPU: the pretrain
    CLI with ``--model cspresdet50`` at 128 px, one cell and one head
    repeat, batch 2, 4 steps validating every 2nd with --eval-map: finite
    losses and val_mAP at each validation; nothing launches."""
    tiny = ["--image-size", "128", "--fpn-repeats", "1", "--head-repeats",
            "1", "--batch-size", "2", "--workers", "1", "--steps", "4",
            "--val-freq", "2", "--val-steps", "1", "--log-freq", "2",
            "--warmup-steps", "2"]
    with torch.enable_grad():
        state, logs, timer, launches = chip_smoke.breadth_pretrain(
            str(tmp_path), device="cpu", extra=tiny)
    assert state.step == 4 and len(timer.times) == 4
    assert state.model.config.backbone_name == "cspresnet50"
    assert [e["step"] for e in logs if "val_mAP" in e] == [2, 4]
    assert set(launches.values()) == {0}


def test_remat_pair_drive_runs_on_the_cpu(tmp_path):
    """Phase 13 (c)'s drive (remat_pair) on the CPU: EfficientDet-D4 at
    256 px (one cell, one head repeat), batch 2, --dropout 0.2, plain and
    with --remat 3 --remat-fpn-heads: the first step's loss and grad_norm
    within 1e-5 relative, the BatchNorm statistics after step 1 within
    1e-6, the flags in each run's model config."""
    tiny = ["--image-size", "256", "--fpn-repeats", "1", "--head-repeats",
            "1", "--batch-size", "2", "--workers", "1"]
    with torch.enable_grad():
        runs = chip_smoke.remat_pair(str(tmp_path), device="cpu",
                                     extra=tiny)
    plain, remat = runs["plain"][0], runs["remat"][0]
    assert len(plain.metrics) == len(remat.metrics) == 3
    # the drop masks differ from step to step: a mask stream per step
    assert plain.metrics[0]["loss"] == remat.metrics[0]["loss"]
    assert plain.stats.keys() == remat.stats.keys() and plain.stats
    assert all(set(run[3].values()) == {0} for run in runs.values())


def test_data_parallel_drives_run_on_the_cpu(tmp_path):
    """Phase 14's drives (a), (c) and (d) on the CPU with two gloo ranks
    at 128 px (a one-cell, one-repeat D0), each launched by torchrun as on
    the card, with every check of the phase that does not need the card:
    (a) step 1 of 2 ranks x 2 images against one process x 4 and the
    pretrain CLI's merged val losses, saved_best and rank-0 checkpoint
    writes; (c) validate --mesh 2 over a 5-image fixture (the last image
    run by rank 0 alone) against one process, the ground truth at AP 1.0
    through the merged evaluators; (d) the meta driver with
    --episode-mesh 2 equal on both ranks, and the sharded meta step
    against sequential accumulation."""
    tmp = str(tmp_path)
    tiny = {"fpn_cell_repeats": 1, "box_class_repeats": 1}
    flags = ["--fpn-repeats", "1", "--head-repeats", "1"]
    with torch.enable_grad():
        ranks = chip_smoke.dp_pretrain_path(
            tmp, device="cpu", img=128, classes=4, batch=2, overrides=tiny,
            steps=2, val_freq=1, cli_extra=flags + [
                "--image-size", "128", "--workers", "1",
                "--warmup-steps", "2"])
    assert [r["world"] for r in ranks] == [2, 2]
    assert all(r["step1_collectives"] > 50 for r in ranks)
    assert ranks[0]["ckpt_writes"] and not ranks[1]["ckpt_writes"]
    with torch.no_grad():
        vranks, one = chip_smoke.dp_validate_path(
            tmp, device="cpu", img=128, batch=2, n_images=5)
    assert [r["rows"] for r in vranks] == [[2, 1], [2, 0]]
    assert one["images"] == 5
    meta_flags = flags + ["--img-size", "128", "--qry-img-size", "128",
                          "--num-sup", "2", "--num-qry", "2",
                          "--num-zero-images", "1"]
    meta_kw = dict(img_size=128, qry_img_size=128, num_sup=2, num_qry=2,
                   num_zero_images=1)
    with torch.enable_grad():
        mranks = chip_smoke.dp_meta_path(tmp, device="cpu",
                                         driver_extra=meta_flags,
                                         overrides=tiny, meta_kw=meta_kw)
    assert all(r["builds"] >= 4 for r in mranks)


def test_spatial_drive_runs_on_the_cpu(tmp_path):
    """Phase 16's drive on the CPU: two gloo ranks launched by torchrun as
    on the card, splitting the rows of a one-cell, one-repeat D0 at 128 px
    as a (1, 2) mesh, with every check of the phase that does not need
    the card: step 1 of the spatial step against one process on the same
    4 images (phase 14 (a)'s bars), a further timed step with finite
    metrics, the exchanges counted, and the profiled step's ``spatial_*``
    spans seeing every one of them."""
    with torch.enable_grad():
        ranks = chip_smoke.spatial_path(
            str(tmp_path), device="cpu", img=128, classes=4, batch=4,
            overrides={"fpn_cell_repeats": 1, "box_class_repeats": 1},
            steps=1)
    for r in ranks:
        assert r["shape"] == {"data": 1, "spatial": 2}
        ex = r["step1_exchanges"]
        assert ex["halo"] > 50 and ex["gather"] > 0 and ex["se_sum"] > 0
        assert r["exchanges"] == ex
        assert (r["window"]["halos"], r["window"]["gathers"],
                r["window"]["se_sums"]) == (ex["halo"], ex["gather"],
                                            ex["se_sum"])


def test_stage_seconds_splits_a_timed_run():
    """Phase 15's stage reader: each stage ends at the first later line
    its predicate accepts; a stage whose line never comes is None and its
    time goes to the next; the rest runs to the end of the call."""
    timed = [(1.0, {"phase": "train"}), (4.0, {"step": 100}),
             (9.0, {"step": 200}), (9.5, {"set": "known"}),
             (10.0, {"result": 1})]
    stages = chip_smoke.stage_seconds(timed, 12.0, [
        ("build", lambda o: o.get("phase") == "train"),
        ("train", lambda o: o.get("step") == 200),
        ("forward", lambda o: o.get("phase") == "forward_done"),
        ("evaluate", lambda o: "result" in o)])
    assert stages == {"build": 1.0, "train": 8.0, "forward": None,
                      "evaluate": 1.0, "rest": 2.0}


def test_timed_lines_keep_each_printed_line():
    sink = chip_smoke.TimedLines()
    print('{"a": 1}\nplain', file=sink)
    sink.write('{"b"')
    sink.write(': 2}\n')
    assert [line for _, line in sink.lines] == ['{"a": 1}', "plain",
                                                '{"b": 2}']
    assert all(t >= 0 for t, _ in sink.lines)


@pytest.mark.parametrize("min_pascal", [0.0, 1.01])
def test_examples_path_drive_runs_on_the_cpu(tmp_path, min_pascal):
    """Phase 15's drive (examples_path) on the CPU at 128 px, 2 steps,
    32 val images: both examples' lines are captured and timed, their
    result checks pass (finite AUROC / FPR95 and mAPs, approx's overlap
    with exact at least 0.99, the --out file equal to the result) and the
    plain versions launch nothing; a PASCAL bar the 2-step detector cannot
    reach fails the phase."""
    kw = dict(device="cpu", min_pascal=min_pascal,
              open_args=["--steps", "2", "--image-size", "128"],
              select_args=["--steps", "2", "--image-size", "128",
                           "--val-images", "32"])
    if min_pascal > 1:
        with torch.enable_grad(), pytest.raises(AssertionError,
                                                match="PASCAL mAP@0.5"):
            chip_smoke.examples_path(str(tmp_path), **kw)
        return
    with torch.enable_grad():
        out = chip_smoke.examples_path(str(tmp_path), **kw)
    result, stages, launches = out["open_set_demo"]
    assert np.isfinite(result["auroc_gt_regions"])
    assert set(stages) == {"build", "train", "evaluate", "rest"}
    assert set(launches.values()) == {0}
    result, stages, launches = out["selection_quality"]
    assert set(result) == {"exact", "approx", "per_anchor"}
    assert result["approx"]["overlap_vs_exact"] >= 0.99
    assert all(stages[k] is not None for k in ("build", "train", "forward",
                                               "exact", "approx",
                                               "per_anchor"))
    assert set(launches.values()) == {0}


def test_examples_started_before_another_phase_on_the_cpu(tmp_path):
    """main's order for phase 15 on the CPU: its example processes start
    (start_examples on examples_argvs), other work runs beside them, and
    examples_path then joins the started processes and checks their
    results; stop_examples kills processes still running."""
    open_args = ["--steps", "2", "--image-size", "128"]
    select_args = open_args + ["--val-images", "32"]
    argvs = chip_smoke.examples_argvs(str(tmp_path), "cpu", open_args,
                                      select_args)
    assert argvs["selection_quality"][:2] == [
        "--out", str(tmp_path / "selection_quality_out.json")]
    started = chip_smoke.start_examples(str(tmp_path), argvs)
    assert set(started) == {"open_set_demo", "selection_quality"}
    with torch.enable_grad():
        out = chip_smoke.examples_path(
            str(tmp_path), device="cpu", open_args=open_args,
            select_args=select_args, min_pascal=0.0, started=started)
    assert all(proc.poll() == 0 for proc in started.values())
    assert out["selection_quality"][0]["approx"]["overlap_vs_exact"] >= 0.99
    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(60)"])
    chip_smoke.stop_examples({"sleeper": sleeper})
    assert sleeper.poll() is not None


def test_example_kernel_inputs_have_the_examples_shapes():
    """Phase 15's kernel inputs on the CPU: selection_quality's val batch
    (16 images, 100 padded rows) against D0@256's 12,276 anchors, and
    5,000 ``exact`` candidates an image of which the NMS keeps some."""
    anchors, anchor_boxes, boxes, cls, cand = \
        chip_smoke.example_kernel_inputs(device="cpu")
    assert anchor_boxes.shape == (12276, 4)
    assert boxes.shape == (16, 100, 4) and cls.shape == (16, 100)
    assert (cls > 0).sum(dim=1).min() >= 1
    assert cand.logits.shape == (16, 5000, 1)
    dets, keep = chip_smoke.pp.batch_detection(*cand[:4], kernels=False)
    assert (keep >= 0).sum() > 16


def test_bench_drive_runs_on_the_cpu(tmp_path, monkeypatch):
    """Phase 17's drive (bench_path) on the CPU at 128 px: run_bench's
    default run (the three rows in the JAX bench's names and order, each
    timed call counted), the meta mode at 128 / 128 and the loader mode,
    the CLI as a subprocess (D0@512, batch 1), a train_roofline row with
    its trace and the predict sweep (one small config in place of
    D4@1024); every row finite, every roofline share in (0, 1]. The
    launch checks and the busy-time ceiling need the card."""
    monkeypatch.setattr(chip_smoke.run_roofline_sweep, "PREDICT_CONFIGS", [
        dict(model="efficientdet_d0", batch=1, freeze_bn="none", remat=0,
             task="predict", image_size=128)])
    tiny = {"image_size": (128, 128), "fpn_cell_repeats": 1,
            "box_class_repeats": 1, "max_detection_points": 3000}
    with torch.no_grad():                   # as the script runs
        out = chip_smoke.bench_path(
            str(tmp_path), device="cpu", batch=1, iters=1, meta_iters=1,
            overrides=tiny,
            roofline_args=("--batch", "1", "--image-size", "128", "--iters",
                           "1"),
            meta_size=(128, 128),
            cli_env={"EXTRA": "0", "BATCH": "1", "ITERS": "1"})
    assert [rec["calls"] for rec in out["records"]] == [4, 4, 4]
    assert out["rows"][-1]["metric"] == (
        "efficientdet_d0@128 e2e inference (preproc+fwd+softNMS+OOD), bs=1")
    assert out["meta"]["unit"] == "episodes/sec"
    assert out["cli"]["metric"].endswith("bs=1")
    assert out["roofline"]["task"] == "train"
    assert out["sweep"]["task"] == "predict" and out["sweep"]["batch"] == 1


def test_pretrained_drive_runs_on_the_cpu(tmp_path):
    """Phase 18's drive (pretrained_path) on the CPU at 128 px, batch 2:
    ``odt.create_model(pretrained=True)`` over a filled cache with
    ``urlretrieve`` raising, answering as ``checkpoint_path=`` on the same
    file bit for bit and as the plain path; a timm training checkpoint's
    EMA copy picked by ``checkpoint_ema=True`` and equal to a bare file of
    it, and read by the deploy CLI as "reference"; the plain versions
    launch nothing."""
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():                   # as the script runs
        launches, compared, times = chip_smoke.pretrained_path(
            str(tmp_path), gen, device="cpu", img=128, batch=2,
            overrides={"max_detection_points": 3000})
    assert set(launches.values()) == {0}
    assert compared[2].ood_all.shape == (2, 3069)
    assert times["seconds"] > 0 and times["request_ms"] > 0
    assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == [
        "efficientdet_d0-f3276ba8.pth"]
