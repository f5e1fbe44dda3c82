"""``BENCHMARK.json`` against its contract, every file it names, and the
imports of the harness: nothing of JAX or of the JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "hnsw_tpu"}
SOURCES = sorted((ROOT / "benchmark").rglob("*.py"))


def test_names_units_and_keys():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in SPEC[group]]
        assert len(seen) == len(set(seen)), group
        assert all(NAME.match(n) for n in seen), group
    for w in SPEC["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in moves and m["moves"] != "setup_s"
    assert 1 <= SPEC["run_seconds"] <= 51 and SPEC["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_file_a_cell_names_loads(cell):
    w, c = harness.cell_spec(SPEC, cell)
    cfg = json.loads((ROOT / c["file"]).read_text())
    wl = json.loads((ROOT / "benchmark" / "workloads" / f"{cell}.json").read_text())
    assert cfg["name"] == c["name"] and wl["traffic"] == w["traffic"]
    assert set(c["reduced"]) == set(cfg["reduced"])
    assert (ROOT / "benchmark" / "entries" / f"{wl['entry']}.py").exists()
    assert (ROOT / "benchmark" / "references" / f"{cfg['metric']}.py").exists()
    assert (ROOT / "benchmark" / "datagen" / f"{cfg['data']['recipe']}.py").exists()
    assert (ROOT / "benchmark" / "engines" / f"{cfg['index']['engine']}.py").exists()
    assert {"dist_gap"} <= set(wl["limits"]) and 0 < cfg["recall_floor"] <= 1
    e2e = harness.metric_specs(SPEC, cell, False)
    layer = harness.metric_specs(SPEC, cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    reported = {m["name"] for m in e2e}
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in reported


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["references/__init__.py", "references/L2.py", "judge.py",
                                  "datagen/__init__.py", "datagen/gauss.py", "roofline.py",
                                  "tracing.py", "loop.py"])
def test_the_yardstick_takes_nothing_of_the_program(name):
    assert "hnsw_tpu_torch" not in _imports(ROOT / "benchmark" / name)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Every module of the harness and the program it drives, imported in a
    fresh process: ``sys.modules`` holds no top-level name of JAX's."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib, pathlib\n"
        "from benchmark import harness, control\n"
        "import hnsw_tpu_torch\n"
        "for part in ('entries', 'engines', 'datagen'):\n"
        "    for p in sorted(pathlib.Path(%r, part).glob('*.py')):\n"
        "        importlib.import_module(f'benchmark.{part}.' + p.stem)\n"
        "for p in sorted(pathlib.Path(%r).glob('metrics/*.py')):\n"
        "    harness.reader(p.stem)\n"
        "from benchmark import references; references.for_metric('L2')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(ROOT / "benchmark"), str(ROOT / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "hnsw_tpu_torch" in tops and not tops & FORBIDDEN
