"""The port's BOP sweep on the CPU: ``run_bop_sweep --device cpu`` over two
synthetic datasets at the tiny sizes of ``tests/test_torch_trainer.py::TINY``.

Each stage runs in a process of its own (``python -m
gdrnpp_bop2022_torch.tools.test_yolox`` then ``...test_gdrn``; none imports
jax), the datasets registered from ``--dataset-meta`` files, the GDRN
options (``--opts``, ``{ds}`` replaced) forwarded to every GDRN stage. On the
first dataset each stage's outputs equal those of running ``test_yolox`` ->
``test_gdrn`` directly on the same arguments: the handoff json row for row
(the time column aside), the poses CSV (the time column aside),
``scores.json`` exactly (the second dataset runs the same stage code); the
summary holds both datasets' ``scores.json`` and ``mean_AR``. As
``tests/test_sweep.py`` (the JAX sweep, marked slow), yolox_s at 64^2 with
random weights.
"""

import json
import os

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.bop.inout import load_bop_results, load_json
from gdrnpp_bop2022_torch.datasets.meta import register_meta_file
from gdrnpp_bop2022_torch.tools import run_bop_sweep, test_gdrn, test_yolox
from synth_utils import K, build_synth_bop

NAMES = ("syntha", "synthb")
# tests/test_torch_trainer.py::TINY (importing that file costs seconds)
TINY = {"model.pose_net.num_classes": 2, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32"}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _opts():
    return [f"{k}={v!r}" for k, v in TINY.items()] + ["datasets.test=('{ds}_test',)"]


def test_sweep_equals_the_stages_run_directly(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")          # the stage processes
    root = tmp_path / "BOP"
    metas = []
    for i, name in enumerate(NAMES):
        build_synth_bop(root / name, split="test", n_images=1, seed=30 + i)
        p = tmp_path / f"{name}.json"
        p.write_text(json.dumps({"name": name, "id2obj": {"1": "cube", "2": "small_cube"},
                                 "width": 160, "height": 120,
                                 "camera_matrix": K.ravel().tolist()}))
        metas.append(str(p))
    out = tmp_path / "sweep"
    rc = run_bop_sweep.main([
        "--datasets", *NAMES, "--root", str(root), "--mode", "eval", "--config", "default",
        "--opts", *_opts(), "--opts", f"output_dir={str(tmp_path / 'gdrn_{ds}')!r}",
        "--out", str(out), "--yolox-size", "yolox_s", "--yolox-input-size", "64",
        "--yolox-allow-random", "--gdrn-seed", "0", "--dataset-meta", *metas,
        "--device", "cpu"])
    assert rc == 0
    summary = load_json(str(out / "sweep_summary.json"))
    assert set(NAMES) <= set(summary) and "mean_AR" in summary

    for name in NAMES:                                   # both datasets scored
        inf_s = tmp_path / f"gdrn_{name}" / "inference" / f"{name}_test"
        scores = load_json(str(inf_s / "scores.json"))
        assert scores == summary[name] and 0.0 <= scores["AR"] <= 1.0
        stats = load_json(str(inf_s / "stats.json"))
        n_rows = len(load_bop_results(str(inf_s / "poses.csv")))
        assert stats["n_rois"] == n_rows > 0 and stats["launches"]["layer_norm"] == 0  # the CPU

    # the stages run directly, on the first dataset (the second goes through
    # the same stage code)
    name, meta = NAMES[0], metas[0]
    register_meta_file(meta)
    direct = tmp_path / f"direct_{name}"
    test_yolox.main(["--dataset", name, "--root", str(root), "--split", "test", "--size",
                     "yolox_s", "--input-size", "64", "--allow-random-weights", "--out",
                     str(direct), "--device", "cpu"])
    det = f"yolox_{name}_test_bboxes.json"
    want, got = (load_json(str(d / det)) for d in (direct, out / f"yolox_{name}"))
    assert want.keys() == got.keys()
    for k in want:
        assert [{**r, "time": 0} for r in want[k]] == [{**r, "time": 0} for r in got[k]]
    opts = [o.replace("{ds}", name) for o in _opts()]
    test_gdrn.main(["--config", "default", "--seed", "0", "--device", "cpu", "--opts",
                    f"datasets.root={str(root)!r}", *opts,
                    f"output_dir={str(direct)!r}",
                    f"datasets.det_files_test=({str(out / f'yolox_{name}' / det)!r},)"])
    inf_d, inf_s = (p / "inference" / f"{name}_test" for p in (direct, tmp_path / f"gdrn_{name}"))
    a, b = load_bop_results(str(inf_d / "poses.csv")), load_bop_results(str(inf_s / "poses.csv"))
    assert len(a) == len(b) > 0
    for ra, rb in zip(a, b):
        assert {k: ra[k] for k in ("scene_id", "im_id", "obj_id", "score")} == \
            {k: rb[k] for k in ("scene_id", "im_id", "obj_id", "score")}
        np.testing.assert_array_equal(ra["R"], rb["R"])
        np.testing.assert_array_equal(ra["t"], rb["t"])
    assert load_json(str(inf_d / "scores.json")) == load_json(str(inf_s / "scores.json"))

def test_sweep_skips_what_it_cannot_run(tmp_path, capsys):
    """An unknown config, or no GDRN weights, skips the dataset (no stage
    runs); with nothing scored the run returns 1, as the JAX sweep does."""
    det = tmp_path / "dets.json"
    det.write_text("{}")
    assert run_bop_sweep.main(["--datasets", "nosuch", "ycbv", "--config", "{ds}_convnext_base",
                               "--out", str(tmp_path), "--device", "cpu", "--opts",
                               f"datasets.det_files_test=({str(det)!r},)"]) == 1
    out = capsys.readouterr().out
    assert "[skip] no config for nosuch" in out and "[ycbv] no GDRN weights" in out
