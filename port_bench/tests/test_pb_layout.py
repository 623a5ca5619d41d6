"""The manifest, and the files the harness finds by name."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import run as bench_run

MANIFEST = bench_run.load_json(bench_run.CHECKOUT / "BENCHMARK.json")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    run = bench_run.Run(MANIFEST, cell, 1, 1.0, False, None)
    assert run.config["model"]["name"] == run.config["zoo_name"]
    driver = __import__(f"port_bench.drivers.{run.traffic['driver']}",
                        fromlist=["run"])
    assert callable(driver.run)
    assert set(run.limits) == set(driver.CHECKS)
    assert "setup_s" in run.end_to_end and len(run.end_to_end) >= 2
    assert run.per_layer
    for name in run.per_layer:
        assert bench_run.reader(name)({}) is None     # nothing to read


def test_manifest_keeps_to_its_contract():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        movers = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(movers)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in MANIFEST["configs"]:
        assert Path(bench_run.CHECKOUT, c["file"]).exists()
        assert c["reduced"] == bench_run.load_json(
            bench_run.CHECKOUT / c["file"])["reduced"]


def test_a_new_cell_is_only_new_files(tmp_path):
    """A cell, its traffic mix and its limits added as files (and one
    entry of the manifest) resolve without any file being edited."""
    shutil.copytree(bench_run.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    manifest["workloads"].append(
        {"name": "d0_predict_b64", "config": "efficientdet_d0",
         "traffic": "predict_b64", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    traffic = bench_run.load_json(bench_run.ROOT / "traffic" /
                                  "predict_b128.json")
    traffic["batch"] = 64
    (tmp_path / "port_bench/traffic/predict_b64.json").write_text(
        json.dumps(traffic))
    shutil.copy(bench_run.ROOT / "limits/d0_predict_b128.json",
                tmp_path / "port_bench/limits/d0_predict_b64.json")
    code = ("from port_bench import run as r\n"
            "m = r.load_json(r.CHECKOUT / 'BENCHMARK.json')\n"
            "x = r.Run(m, 'd0_predict_b64', 1, 1.0, False, None)\n"
            "print(x.traffic['batch'], sorted(x.limits), sorted(x.per_layer))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, check=True).stdout
    assert out.startswith("64 ['box_err_image', 'class_err', 'empty_rows', "
                          "'ood_err', 'pick_gap_mean', 'score_err_mean']")


def test_the_harness_alone_refuses_to_run(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    (no program) a run exits with an error and prints no result."""
    shutil.copytree(bench_run.ROOT, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(bench_run.CHECKOUT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "d0_predict_b128", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True)
    assert p.returncode != 0 and not p.stdout.strip()
