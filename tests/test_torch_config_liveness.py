"""Every field of the port's ``MetaConfig`` is read somewhere in the port
(a mirror of tests/test_config_liveness.py for the JAX package's): a
field that parses but is never read off a config object outside its own
definition fails here. ``run_bench.py`` counts as a reader, as the JAX
test counts root ``bench.py``: its meta row reads the episode's shape
off the config."""
import dataclasses
import io
import pathlib
import re
import tokenize

import pytest

import ood_object_detection_tpu_torch
from ood_object_detection_tpu_torch.meta.config import MetaConfig

PKG_ROOT = pathlib.Path(ood_object_detection_tpu_torch.__file__).parent
RUN_BENCH = PKG_ROOT / "run_bench.py"

# fields intentionally without a read in the port, with the reason
DOCUMENTED_DEAD: dict = {}

# receivers whose attribute access counts as a config read
_CONFIG_RECEIVERS = r"(?:self\.)?(?:meta_cfg|meta_config|mcfg|cfg|config)"
# the fields of the JAX bench's meta row (bench.py:320-355)
BENCH_READS = ("num_sup", "num_qry", "num_zero_images", "proj_size",
               "proj_depth", "steps")


def _strip_comments_and_strings(source: str) -> str:
    """Drop COMMENT and STRING tokens so that prose mentions of a field
    cannot count as reads."""
    out = []
    toks = tokenize.generate_tokens(io.StringIO(source).readline)
    for tok in toks:
        if tok.type in (tokenize.COMMENT, tokenize.STRING):
            continue
        out.append(tok.string)
    return " ".join(out)


def _reads(source: str, field: str) -> bool:
    pattern = re.compile(r"\b" + _CONFIG_RECEIVERS + r"\s*\.\s*"
                         + re.escape(field) + r"\b")
    return bool(pattern.search(source))


def _port_source() -> str:
    paths = [p for p in sorted(PKG_ROOT.rglob("*.py"))
             if not (p.name == "config.py" and p.parent.name == "meta")]
    assert RUN_BENCH in paths
    return "\n".join(_strip_comments_and_strings(p.read_text())
                     for p in paths)


def test_every_meta_config_field_is_read_somewhere():
    src = _port_source()
    dead = [f.name for f in dataclasses.fields(MetaConfig)
            if f.name not in DOCUMENTED_DEAD and not _reads(src, f.name)]
    assert not dead, (f"MetaConfig fields parsed but never read by the "
                      f"port: {dead}")


@pytest.mark.parametrize("field", BENCH_READS)
def test_run_bench_reads_the_meta_rows_fields(field):
    assert _reads(_strip_comments_and_strings(RUN_BENCH.read_text()), field)


def test_a_field_never_read_is_caught():
    src = _strip_comments_and_strings(
        '"""meta_cfg.steps in a docstring"""\n'
        "x = meta_cfg.num_sup  # meta_cfg.steps in a comment\n"
        "y = args.steps\n")
    assert _reads(src, "num_sup")
    assert not _reads(src, "steps")
