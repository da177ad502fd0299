"""BENCHMARK.json against the benchmark's contract, and what the harness may import."""

import ast
import json
import re
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["bench_h100"] and MANIFEST["command"][1] == "bench_h100/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _one_line(s, n=200):
    return 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_configs_and_cells():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench_h100/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and _one_line(c["why"]) and _one_line(c["source"])
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    cells = MANIFEST["workloads"]
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and _one_line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    assert {w["config"] for w in cells} == set(configs)


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    assert set(e2e) == {"setup_s", "serve_rois_per_s", "batch_p95_ms"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in MANIFEST["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in {"host_clock", "device_trace"}
    layers = set()
    for m in MANIFEST["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] == "serve_rois_per_s" and set(m["workloads"]) <= cells
        assert m["source"] in SOURCES and _one_line(m["layer"])
        layers.add(m["layer"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for cell in cells:   # setup_s and one more end to end; a per-layer metric moves one it has
        mine = {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}
        assert "setup_s" in mine and len(mine) >= 2, cell
        assert all(m["moves"] in mine for m in MANIFEST["per_layer"] if cell in m["workloads"])
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))
    assert {m["name"] for m in MANIFEST["per_layer"] if m["name"].endswith("_roofline_pct")}
    assert any("mfu" in n for n in names)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


SOURCES_PY = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES_PY, ids=lambda p: str(p.relative_to(BENCH)))
def test_nothing_imports_jax_or_the_jax_package(path):
    # the part before the first dot, whole: gdrnpp_bop2022_torch begins with the JAX package's name
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "gdrnpp_bop2022_tpu"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "gdrnpp_bop2022_torch" not in {n.split(".")[0] for n in _imports(path)}


def test_a_run_refuses_a_machine_without_a_card():
    import subprocess
    import sys
    cell = MANIFEST["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", cell, "--seed", "1",
                        "--seconds", "1"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout.strip() == ""
