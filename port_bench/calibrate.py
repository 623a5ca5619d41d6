"""The readings that a cell's limits are set from, in one process:

    python3 -m port_bench.calibrate --workload <cell> --seconds 3 \
        --seeds 11,12,... --control-seeds 21,22,23 [--faults half_batch]

For each ``--seeds`` seed, one run of the cell as the benchmark makes it (a
short window, untraced): the numbers compared, the program's readings. For
each ``--control-seeds`` seed, the same numbers with the control in the
program's place: the reference computed in float8 (e4m3, one scale a
tensor), one precision below the configuration's bfloat16; in a predict
cell its detections through its own soft-NMS, in a train cell its first
steps. ``--faults`` reads faults on the program: in a train cell a step
fed half of each batch (the loss over the rest), on the control seeds; in
a predict cell, on each run's own outputs, half of each request's images
left unanswered (``half_batch``), one detection altered (``altered``),
every class id one higher (``class_shift``) or every score a tenth high
(``rescored``), and, on the control seeds, the program run with hard NMS
in place of soft-NMS (``hard_nms``). Each reading is one JSON line on standard output. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import run as bench_run


def _line(**kw) -> None:
    print(json.dumps(kw), flush=True)


def program(run, faults=()) -> dict:
    """The program's readings, and each predict fault's on its outputs."""
    from importlib import import_module
    driver = import_module(f"port_bench.drivers.{run.traffic['driver']}")
    out = driver.run(run)
    readings = {"program": out.get("readings", out["checks"])}
    for fault in faults:
        if fault in getattr(driver, "FAULTS", {}):
            readings[fault] = driver.judge(
                out["setup"], driver.FAULTS[fault](out["served"]))["readings"]
    return readings


def control(run) -> dict:
    kind = run.traffic["driver"]
    if kind == "predict":
        from .drivers import predict as p
        s = p.Setup(run)
        del s.bench
        torch.cuda.empty_cache()
        p.strict_reference()
        # the pool batches a run of this seed would judge
        requests = p.sample(run, 100)
        return p.judge(s, p.control(s, requests))["readings"]
    from .drivers import train as t
    s = t.Setup(run)
    del s.bench, s.step, s.train_state, s.tx
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = run.traffic["checked_steps"]
    ref = t.reference_steps(s.ref, s.cfg, s.tcfg, s.state, s.pool, n,
                            s.device)
    low = t.reference_steps(s.ref, s.cfg, s.tcfg, s.state, s.pool, n,
                            s.device, prec="fp8")
    return t.compare(low, ref)


def half_batch(run) -> dict:
    """A train cell's program fed half of every batch's images."""
    from .drivers import train as t
    setup = t.Setup.__init__

    def init(self, r):
        setup(self, r)
        self.full_pool = self.pool
        half = r.traffic["batch"] // 2
        self.pool = [{k: v[:half] for k, v in b.items()} for b in self.pool]
    t.Setup.__init__ = init
    try:
        s = t.Setup(run)
        n = run.traffic["checked_steps"]
        got = s.first_steps(n)
        full = s.full_pool
        del s.bench, s.step, s.train_state, s.tx, s.pool
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        ref = t.reference_steps(s.ref, s.cfg, s.tcfg, s.state, full, n,
                                s.device)
        return t.compare(got, ref)
    finally:
        t.Setup.__init__ = setup


def hard_nms(run) -> dict:
    """A predict cell's program run with hard NMS (its ``soft_nms``
    false) in place of soft-NMS; the reference stays soft."""
    from .drivers import predict as p
    run.config["model"]["soft_nms"] = False
    return p.run(run)["readings"]


TRAIN_FAULTS = {"half_batch": half_batch}
PROGRAM_FAULTS = {"hard_nms": hard_nms}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-runs", type=int, default=1 << 30,
                   help="the program seeds whose outputs the predict "
                        "faults are read on: the first this many")
    args = p.parse_args(argv)
    manifest = bench_run.load_json(bench_run.CHECKOUT / "BENCHMARK.json")
    device = torch.device("cuda", 0)
    seeds = lambda text: [int(x) for x in text.split(",") if x]

    def make(seed):
        return bench_run.Run(manifest, args.workload, seed, args.seconds,
                             False, device)
    faults = [f for f in args.faults.split(",") if f]
    for n, seed in enumerate(seeds(args.seeds)):
        on = faults if n < args.fault_runs else ()
        for kind, checks in program(make(seed), on).items():
            _line(kind=kind, seed=seed, checks=checks)
        torch.cuda.empty_cache()
    for seed in seeds(args.control_seeds):
        _line(kind="control", seed=seed, checks=control(make(seed)))
        torch.cuda.empty_cache()
    for fault in faults:
        for seed in seeds(args.control_seeds):
            run = make(seed)
            table = TRAIN_FAULTS if run.traffic["driver"] == "train" \
                else PROGRAM_FAULTS
            if fault in table:
                _line(kind=fault, seed=seed, checks=table[fault](run))
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
