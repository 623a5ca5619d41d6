"""Cells cut down to a size the CPU runs in seconds: 128 px, a few
images, the program in float32 so that it meets the reference closely."""
import json

import torch

from port_bench import run as bench_run

CPU = torch.device("cpu")
SEED = 2147483999
PREDICT = {"model": {"image_size": [128, 128], "max_detection_points": 3000,
                     "compute_dtype": "float32"},
           "traffic": {"batch": 4, "pool": 2, "check_requests": 2,
                       "reference_block": 4, "true_side": [64, 128],
                       "trace_requests": 2},
           "limits": {"empty_rows": 0, "class_err": 0, "box_err_image": 1e-3,
                      "pick_gap_mean": 1e-3, "score_err_mean": 1e-3,
                      "ood_err": 1e-3}}
TRAIN = {"model": {"image_size": [128, 128], "compute_dtype": "float32"},
         "traffic": {"batch": 4, "pool": 4, "box_side": [8, 128]},
         "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3,
                    "ema_gap": 1e-3, "grad_gap_median": 1e-4,
                    "change_gap_median": 1e-4}}


def overrides(cell, model=None):
    """The small cell's overrides, with ``model`` fields on top."""
    o = json.loads(json.dumps(PREDICT if "predict" in cell else TRAIN))
    o["model"].update(model or {})
    return o


def make_run(cell, seed=SEED):
    manifest = bench_run.load_json(bench_run.CHECKOUT / "BENCHMARK.json")
    return bench_run.Run(manifest, cell, seed, 1.0, False, CPU,
                         overrides(cell))


def line(cell, capsys, seed=SEED, seconds=1.0, model=None):
    """One run of ``cell`` on the CPU at the small size (``model`` fields
    changed on top): its result line."""
    rc = bench_run.main(["--workload", cell, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", "0"],
                        device=CPU, overrides=overrides(cell, model))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
