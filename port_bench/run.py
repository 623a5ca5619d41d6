"""One run of one benchmark cell of the PyTorch / CUDA port.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; the configuration's file, the traffic's
file (``traffic/<name>.json``, which names its driver,
``drivers/<kind>.py``), the cell's limits (``limits/<cell>.json``) and each
per-layer metric's reader (``metrics/<name>.py``) are found by name, so a
new cell, mix, driver or metric is a new file.

The driver makes the weights and the inputs from ``--seed``, warms up,
measures for ``--seconds``, and checks what the window produced against
the plain reference (``reference/``). With ``--trace 1`` it then profiles a
fixed count of calls and the line carries the per-layer metrics; with
``--trace 0`` the end-to-end ones. The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the line's last key.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "ood_object_detection_tpu")
os.environ["USE_FLAX"] = "0"
# every build and kernel cache at a fixed place inside the checkout
CACHE = CHECKOUT / ".port_bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``, 10 ms steps)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start / os.sysconf("SC_CLK_TCK")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def reader(metric: str):
    """The per-layer metric's reader, ``metrics/<metric>.py``."""
    path = ROOT / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + metric.replace(".", "__"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Run:
    """What a driver is given: the cell, its configuration, traffic and
    limits, the run's arguments, the device, and the metric names the line
    has to carry."""

    def __init__(self, manifest: Dict, cell: str, seed: int, seconds: float,
                 trace: bool, device, overrides: Optional[Dict] = None):
        entry = next((w for w in manifest["workloads"] if w["name"] == cell),
                     None)
        if entry is None:
            raise SystemExit(f"no workload {cell!r} in BENCHMARK.json")
        conf = next(c for c in manifest["configs"]
                    if c["name"] == entry["config"])
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device, self.chips = trace, device, entry["chips"]
        self.config = load_json(CHECKOUT / conf["file"])
        self.traffic = load_json(ROOT / "traffic" / f"{entry['traffic']}.json")
        limits = ROOT / "limits" / f"{cell}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        for key, values in (overrides or {}).items():
            part = self.config["model"] if key == "model" else \
                getattr(self, key)
            part.update(values)

        def mine(m):
            return cell in m.get("workloads", [cell])
        self.end_to_end = {m["name"]: m["unit"] for m in manifest["end_to_end"]
                           if mine(m)}
        self.per_layer = {m["name"]: m["unit"] for m in manifest["per_layer"]
                          if mine(m)}


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None, device=None,
         overrides: Optional[Dict] = None) -> int:
    """Run one cell once and print its line. ``device`` (the tests' CPU)
    skips the look for cards; without it the run needs as many CUDA cards
    as the cell asks for. ``overrides`` ({'model' | 'traffic' | 'limits':
    {key: value}}) shrink a cell for the tests."""
    args = parse(argv)
    manifest = load_json(CHECKOUT / "BENCHMARK.json")
    import torch
    run = Run(manifest, args.workload, args.seed, args.seconds,
              bool(args.trace), device, overrides)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < run.chips:
            print(f"port_bench: {run.cell} needs {run.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        run.device = torch.device("cuda", 0)
    driver = importlib.import_module(
        f"port_bench.drivers.{run.traffic['driver']}")
    out = driver.run(run)

    banned = banned_modules()
    if banned:
        print(f"port_bench: loaded {banned}, which the port must not load",
              file=sys.stderr)
        return 3

    if run.trace:
        metrics = {}
        for name, unit in run.per_layer.items():
            value = reader(name)(out["layer"])
            if value is not None:
                metrics[name] = {"value": value, "unit": unit}
    else:
        metrics = {name: {"value": out["end_to_end"][name], "unit": unit}
                   for name, unit in run.end_to_end.items()}
    checks = {name: {"value": value, "limit": run.limits.get(name)}
              for name, value in out["checks"].items()}
    correct = out["failed"] == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    dev = run.device
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                       "kind": torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu",
                       "count": run.chips,
                       "memory_peak_bytes": out["memory_peak_bytes"]}}
    if run.trace:
        line["device"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        line["breakdown"] = out["breakdown"]
    if "judged" in out:
        line["judged"] = out["judged"]
    line["checks"] = checks
    marks = out.get("setup_marks", {})
    print("setup, seconds since the process started: " + ", ".join(
        f"{k} {v:.2f}" for k, v in marks.items()), file=sys.stderr)
    if "judged" in out:
        print(f"judged {out['judged']} requests", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
