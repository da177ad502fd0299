"""The check that decides ``correct``, on the CPU at toy sizes.

The port in fp32 against the plain reference (they agree to rounding), then
runs driven through the whole harness with the served path broken
underneath (``faults.py``): each fault has to come out as not correct at the
cell's own limits. On the card at the cells' sizes ``calibrate.py --fault``
reads the same faults (``PERF.md`` gives the readings).
"""

import pytest
import torch

from bench_h100 import faults
from bench_h100.harness import Session
from bench_h100.tests.tiny import tiny_cell

CONFIGS = ("ycbv_convnext_base", "ycbv_convnext_base_rgbd")
FP32 = {"model.compute_dtype": "float32"}
SEED = 2**31 + 7          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve(config, seconds=0.3):
    return Session(tiny_cell(config, opts=FP32), "cpu").serve(SEED, seconds, trace=False)


@pytest.mark.parametrize("config", CONFIGS)
def test_port_in_fp32_agrees_with_the_reference(config):
    out = serve(config)
    r = out["_readings"]
    assert out["correct"] and r["rows"] > 0 and r["rows_missing"] == 0
    assert r["corner_gap_mm"] < 1e-2 and r["t_gap_rel"] < 1e-5 and r["rot_gap_deg"] < 1e-2


@pytest.mark.parametrize("config", CONFIGS)
def test_traced_run_reports_what_the_cpu_can(config):
    session = Session(tiny_cell(config, opts=FP32), "cpu")
    out = session.serve(SEED + 1, 0.3, trace=True)
    assert out["correct"]
    w = out["_window"]
    assert out["metrics"]["roi_fill"]["value"] == pytest.approx(w["rois"] / (8 * w["batches"]))
    assert out["metrics"]["batch_p95_ms.rgb"]["value"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _faulty(config, fault):
    planted = faults.plant(fault)
    try:
        return serve(config)
    finally:
        planted.remove()


@pytest.mark.parametrize("config", CONFIGS)
def test_half_the_batch_left_out(config):
    """The forward computes the first half of the ROIs; the rest get their mean."""
    assert not _faulty(config, "half_batch")["correct"]


@pytest.mark.parametrize("config,fault", [(CONFIGS[0], "answer_moved:1"),
                                          (CONFIGS[1], "answer_moved:2")])
def test_answers_altered_where_they_are_produced(config, fault):
    """The pose decode moves every translation along x: by 1 mm in the RGB
    cell, 2 mm in the RGB-D cell, whose median corner gap has the limit 1.2 mm."""
    assert not _faulty(config, fault)["correct"]


def test_one_answer_altered_in_the_rgb_cell():
    """One ROI slot of every batch served 5 mm off: the corner gap's 99th
    percentile catches it. The RGB-D cell cannot see it: its depth refinement
    moves a few sound rows by more (see PERF.md)."""
    assert not _faulty(CONFIGS[0], "one_slot_moved:5")["correct"]


@pytest.mark.parametrize("config", CONFIGS)
def test_one_rotation_altered(config):
    """One ROI slot of every batch turned by 1 degree: the share of rows whose
    rotation gap is over 0.4 degrees catches it in both cells."""
    r = _faulty(config, "one_slot_turned:1")
    assert not r["correct"] and r["_readings"]["rot_gap_deg_share_over_0.4"] > 0.01


def test_the_depth_render_altered():
    """B2's place, the depth render of the refinement, reads 1% deep."""
    assert not _faulty(CONFIGS[1], "render_deep:1")["correct"]


@pytest.mark.parametrize("config", CONFIGS)
def test_a_row_dropped(config):
    """The serving loop loses the last row it produced."""
    out = _faulty(config, "row_dropped")
    assert not out["correct"] and out["_readings"]["rows_missing"] == 1
