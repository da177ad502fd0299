"""On the card, at the cells' own sizes: the control fails, a sound run passes,
and a run prints the line the contract asks for.

    python -m pytest bench_h100/tests -m gpu      (on a machine with the card)
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.gpu
ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
INT8 = {"model.pose_net.backbone.int8_mlp": True}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_int8_is_not_correct_and_the_program_is(card, cell):
    """The program's own int8 path (its MLPs in int8, one precision below the
    configuration's bf16) is the control; the bf16 program on the same seed passes."""
    import torch
    from bench_h100.harness import Session, load_cell
    c = load_cell(cell)
    for opts, want in ((INT8, False), ({}, True)):
        session = Session(c, "cuda", opts)
        out = session.serve(4100000001, 2.0, trace=False)
        assert out["correct"] is want, (opts, out["_readings"])
        del session
        torch.cuda.empty_cache()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(card, cell, trace):
    p = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", cell, "--seed",
                        "4100000002", "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "compared" and out["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    dev = out["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in bench[kind] if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == want
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert len(out["breakdown"]["device_ops"]) <= 10
        for name in ("b1_roofline_pct", "serve_mfu_pct", "device_idle_pct"):
            assert 0 < out["metrics"][name]["value"] <= 100
    assert p.stderr.strip().splitlines()[-1].startswith(list(out["compared"])[-1])
