"""The port's evaluation CLI (``gdrnpp_bop2022_torch.tools.test_gdrn``) and
what it reads: GT-box detections against the JAX package, the config and
post-mode choice, and one run on a synthetic BOP split on the CPU.

The run serves a tiny config (convnext_tiny, 64 -> 16, fp32, random weights
from a seed) on GT boxes with ``net_iter_pnp``, writes poses.csv and
scores.json, and its scores equal ``score_csv``'s on the written CSV; a
``--weights`` state dict of the same seed serves the same poses.
"""

import json

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.datasets import bop_data as jbd
from gdrnpp_bop2022_torch.config import Config, parse_opts, replace_cfg
from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd
from gdrnpp_bop2022_torch.datasets import bop_data as tbd
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
from gdrnpp_bop2022_torch.tools import score_csv, test_gdrn
from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
from synth_utils import build_synth_bop

TINY = ["model.pose_net.num_classes=2", "model.pose_net.input_res=64",
        "model.pose_net.output_res=16", "model.pose_net.backbone.name=convnext_tiny",
        "model.pose_net.geo_head.feat_dim=32", "model.pose_net.geo_head.num_gn_groups=8",
        "model.pose_net.geo_head.num_regions=8", "model.pose_net.pnp_net.featdim=32",
        "model.pose_net.pnp_net.num_gn_groups=8", "model.compute_dtype=float32"]


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop")
    syn = build_synth_bop(root / "synth", n_images=2, seed=4)
    jm = syn["meta"]
    meta = register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                                     height=jm.height, camera_matrix=jm.camera_matrix))
    return root, syn, meta


@pytest.mark.parametrize("bbox_type", ["AMODAL_CLIP", "VISIB"])
def test_gt_detections_match_jax(synth, bbox_type):
    root, syn, meta = synth
    want = jbd.gt_detections(jbd.index_bop_split(syn["split_dir"], syn["meta"]), bbox_type)
    got = tbd.gt_detections(tbd.index_bop_split(syn["split_dir"], meta), bbox_type)
    assert got.keys() == want.keys() and len(got) == 2
    for k in want:
        for a, b in zip(want[k], got[k]):
            assert {**a, "bbox_xyxy": None} == {**b, "bbox_xyxy": None}
            np.testing.assert_array_equal(a["bbox_xyxy"], b["bbox_xyxy"])


def test_config_and_post_mode_choice():
    assert test_gdrn.load_config("default") == Config()
    assert test_gdrn.load_config("ycbv_convnext_base_rgbd") == ycbv_convnext_base_rgbd()
    for bad in ("replace_cfg", "Config", "nope"):
        with pytest.raises(ValueError, match="configs.py"):
            test_gdrn.load_config(bad)
    cfg = Config()
    assert test_gdrn.post_mode_of(cfg) == "direct"
    assert test_gdrn.post_mode_of(ycbv_convnext_base_rgbd()) == "depth_refine"
    for mode in ("ransac_pnp", "uncertainty_pnp", "net_iter_pnp"):
        c = replace_cfg(cfg, {"val.use_pnp": True, "val.pnp_type": mode})
        assert test_gdrn.post_mode_of(c) == mode
    with pytest.raises(ValueError, match="pnp_type"):
        test_gdrn.post_mode_of(replace_cfg(cfg, {"val.use_pnp": True, "val.pnp_type": "epnp"}))


def test_cli_serves_and_scores_on_the_cpu(synth, tmp_path, capsys):
    root, syn, meta = synth
    opts = TINY + [f"datasets.root={str(root)!r}", "datasets.test=('synth_test',)",
                   "model.load_dets_test=False", f"output_dir={str(tmp_path / 'out')!r}",
                   "val.use_pnp=True", "val.pnp_type='net_iter_pnp'"]
    results, scores = test_gdrn.main(["--opts", *opts, "--seed", "3", "--device", "cpu"])
    out_dir = tmp_path / "out" / "inference" / "synth_test"
    assert len(results) == 4 and (out_dir / "poses.csv").exists()
    assert json.loads((out_dir / "scores.json").read_text()) == scores
    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd"):
        assert 0.0 <= scores[k] <= 1.0 and np.isfinite(scores[k])
    capsys.readouterr()
    again = score_csv.main(["--csv", str(out_dir / "poses.csv"), "--dataset", "synth",
                            "--root", str(root), "--device", "cpu"])
    for k in ("AR", "AR_vsd", "AR_mssd", "AR_mspd"):
        assert abs(again[k] - scores[k]) <= 1e-6, k

    # the same weights from a .pth state dict serve the same poses
    model = build_gdrn(replace_cfg(Config(), parse_opts(TINY)), device="cpu")
    torch.save({"model": seeded_state_dict(model, 3)}, tmp_path / "w.pth")
    res2, none = test_gdrn.main(["--opts", *opts, "val.save_results_only=True", "--weights",
                                 str(tmp_path / "w.pth"), "--device", "cpu"])
    assert none is None
    for a, b in zip(results, res2):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])
