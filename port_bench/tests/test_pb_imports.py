"""What the benchmark imports: never JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
nothing of the program in the reference."""
import ast
import subprocess
import sys
from pathlib import Path

from port_bench import run as bench_run

BANNED = {"jax", "jaxlib", "flax", "ood_object_detection_tpu"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_names_jax_or_the_jax_package():
    for path in bench_run.ROOT.rglob("*.py"):
        assert not set(imported_tops(path)) & BANNED, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (bench_run.ROOT / "reference").rglob("*.py"):
        assert "ood_object_detection_tpu_torch" not in set(
            imported_tops(path)), path


def test_a_run_and_its_drivers_load_no_jax():
    code = ("import sys, port_bench.run, port_bench.drivers.predict, "
            "port_bench.drivers.train, port_bench.calibrate\n"
            # what the drivers import when they build the system under test
            "import ood_object_detection_tpu_torch.factory, "
            "ood_object_detection_tpu_torch.train, "
            "ood_object_detection_tpu_torch.data.device_preproc\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=bench_run.CHECKOUT, capture_output=True,
                         text=True, check=True).stdout
    tops = set(eval(out))
    assert "ood_object_detection_tpu_torch" in tops
    assert not tops & BANNED
