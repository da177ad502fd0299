"""A cell small enough for the CPU: the harness's whole path at toy sizes."""

import copy
import json
from pathlib import Path

from bench_h100.harness import Cell, load_metric

BENCH = Path(__file__).resolve().parent.parent
P = "model.pose_net."
TINY_OPTS = {P + "backbone.name": "convnext_tiny", P + "input_res": 64, P + "output_res": 16}
TINY_WIDTHS = {"backbone_depths": [3, 3, 9, 3], "backbone_dims": [96, 192, 384, 768],
               "pnp_fc": [1024, 256]}
TINY_MIX = {"frames": 6, "dets_per_frame": {"1": 2, "2": 2, "3": 2}, "batch_size": 8,
            "images_per_batch": 4, "batches": 2, "trace_batches": 2}


def tiny_cell(config: str, opts=None) -> Cell:
    """The configuration file of ``config`` at toy sizes: ConvNeXt-T at 64 in,
    16 out, 120x160 frames (the camera scaled with them, the objects at the
    cell's depths) with toy meshes, batches of 8 ROIs. The limits of
    ``correct`` are the cell's own."""
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    conf = copy.deepcopy(conf)
    conf["program"]["opts"] = {**TINY_OPTS, **(opts or {})}
    conf["model"].update({k: v for k, v in conf["program"]["opts"].items() if k in conf["model"]})
    conf["widths"] = TINY_WIDTHS
    sc = conf["scene"]
    sc.update(width=160, height=120, margin_px=20, mesh_lat_lon=[5, 8])
    sc["K"] = [[266.7, 0.0, 78.2], [0.0, 266.9, 60.3], [0.0, 0.0, 1.0]]
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    name = f"{config}.tiny"
    metrics = lambda ms: [(m["name"], m["unit"], load_metric(m["name"])) for m in ms]  # noqa
    return Cell(name, 1, conf, dict(TINY_MIX), metrics(bench["end_to_end"]),
                metrics(bench["per_layer"]))
