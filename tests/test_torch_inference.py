"""Port parity: the whole serving slice against the JAX package.

Synthetic BOP scene on disk (PNGs, scene json, a detections file) ->
index_bop_split / load_detections -> iter_test_batches ->
run_gdrn_inference(post_mode="direct") -> results_to_bop_rows ->
save_bop_results, once through each package, with the same numpy-drawn
weights (tiny config, fp32). Poses agree at 1e-4 relative (the model
parity bound); the host-side products (records, batches, CSV text apart
from the time column) agree exactly.
"""

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.bop.inout import save_bop_results as j_save
from gdrnpp_bop2022_tpu.datasets import bop_data as jbd
from gdrnpp_bop2022_tpu.datasets.test_loader import iter_test_batches as j_iter
from gdrnpp_bop2022_tpu.engine.inference import run_gdrn_inference as j_run
from gdrnpp_bop2022_tpu.engine.inference import results_to_bop_rows as j_rows
from gdrnpp_bop2022_torch.bop.inout import load_bop_results, save_bop_results
from gdrnpp_bop2022_torch.datasets import bop_data as tbd
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta
from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
from gdrnpp_bop2022_torch.engine.inference import (decode_dense_outputs,
                                                   results_to_bop_rows,
                                                   run_gdrn_inference)
from synth_utils import build_synth_bop
from torch_parity_utils import jax_gdrn_params, port_gdrn, tiny_cfg


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    syn = build_synth_bop(tmp_path_factory.mktemp("bop"), n_images=3)
    jmeta = syn["meta"]
    tmeta = DatasetMeta(name=jmeta.name, id2obj=dict(jmeta.id2obj),
                        width=jmeta.width, height=jmeta.height,
                        camera_matrix=jmeta.camera_matrix)
    cfg = tiny_cfg(**{"model.pose_net.num_classes": 2})
    jm, params = jax_gdrn_params(cfg, seed=3)
    port = port_gdrn(cfg, params)
    extents = syn["bank"].extents

    def host(bd, meta, it):
        records = bd.index_bop_split(syn["split_dir"], meta)
        by_im = bd.make_records_by_image(records)
        dets = bd.load_detections(syn["det_file"], meta)
        return records, dets, list(it(by_im, dets, batch_size=4))

    j_records, j_dets, j_batches = host(jbd, jmeta, j_iter)
    t_records, t_dets, t_batches = host(tbd, tmeta, iter_test_batches)
    kw = dict(input_res=64, output_res=16)
    j_res = j_run(lambda p, b: jm.apply({"params": p}, **b), params, j_batches,
                  extents, **kw)
    stats = {}
    t_res = run_gdrn_inference(port, t_batches, extents, stats=stats, **kw)
    return dict(j=(j_records, j_dets, j_batches, j_res),
                t=(t_records, t_dets, t_batches, t_res), stats=stats,
                port=port, extents=extents, kw=kw)


def test_host_side_matches(slice_run):
    j_records, j_dets, j_batches, _ = slice_run["j"]
    t_records, t_dets, t_batches, _ = slice_run["t"]
    assert len(t_records) == len(j_records) == 6
    for a, b in zip(j_records, t_records):
        assert (a.scene_id, a.im_id, a.obj_id, a.label) == (b.scene_id, b.im_id,
                                                           b.obj_id, b.label)
        np.testing.assert_array_equal(a.K, b.K)
    assert j_dets.keys() == t_dets.keys()
    assert len(t_batches) == len(j_batches) == 2
    for a, b in zip(j_batches, t_batches):
        for k in ("images", "img_idx", "boxes_xyxy", "Ks", "labels", "valid"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_poses_match_jax(slice_run):
    j_res, t_res = slice_run["j"][3], slice_run["t"][3]
    assert len(t_res) == len(j_res) == 6
    for a, b in zip(j_res, t_res):
        assert (a["scene_id"], a["im_id"], a["obj_id"]) == (b["scene_id"], b["im_id"],
                                                           b["obj_id"])
        np.testing.assert_allclose(b["R"], a["R"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b["t"], a["t"], rtol=1e-4, atol=1e-6)
        assert np.isfinite(b["R"]).all() and np.isfinite(b["t"]).all()


def test_timing_semantics(slice_run):
    t_res, stats = slice_run["t"][3], slice_run["stats"]
    assert stats["n_instances"] == 6 and stats["n_batches"] == 2
    assert stats["rois_per_sec"] > 0 and stats["p50_ms"] <= stats["p99_ms"]
    assert stats["device"] == "cpu"
    by_image = {}
    for r in t_res:     # per-image max normalisation, det time included
        by_image.setdefault((r["scene_id"], r["im_id"]), set()).add(r["time"])
        assert r["time"] > 0.01
    assert all(len(v) == 1 for v in by_image.values())


def test_csv_matches_jax(slice_run, tmp_path):
    j_res, t_res = slice_run["j"][3], slice_run["t"][3]
    rows_t = results_to_bop_rows(t_res)
    # the CSV writers agree byte for byte on the same rows
    save_bop_results(tmp_path / "t.csv", rows_t)
    j_save(tmp_path / "j.csv", rows_t)
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    loaded = load_bop_results(tmp_path / "t.csv")
    ref = j_rows(j_res)
    assert len(loaded) == len(ref)
    for a, b in zip(ref, loaded):
        np.testing.assert_allclose(b["t"], a["t"], rtol=1e-4, atol=1e-3)  # mm
        np.testing.assert_allclose(b["R"], a["R"], rtol=1e-4, atol=1e-4)


def test_pipelined_serving_gives_same_poses(slice_run):
    batches, t_res = slice_run["t"][2], slice_run["t"][3]
    res2 = run_gdrn_inference(slice_run["port"], batches, slice_run["extents"],
                              pipeline_depth=2, **slice_run["kw"])
    for a, b in zip(t_res, res2):
        np.testing.assert_array_equal(a["R"], b["R"])
        np.testing.assert_array_equal(a["t"], b["t"])


def test_other_post_modes_name_their_slice(slice_run):
    with pytest.raises(NotImplementedError, match="slice 2"):
        run_gdrn_inference(slice_run["port"], slice_run["t"][2],
                           slice_run["extents"], post_mode="ransac_pnp")


def test_decode_dense_outputs_matches_jax():
    import jax.numpy as jnp
    from gdrnpp_bop2022_tpu.engine.inference import decode_dense_outputs as j_dec
    rs = np.random.RandomState(4)
    for bins in (1, 5):
        out = {k: rs.randn(2, 4, 4, bins).astype(np.float32)
               for k in ("coor_x", "coor_y", "coor_z")}
        out["vis_mask"] = rs.randn(2, 4, 4).astype(np.float32)
        for mlt in ("L1", "BCE"):
            xj, mj = j_dec({k: jnp.asarray(v) for k, v in out.items()}, mlt)
            xt, mt = decode_dense_outputs(
                {k: torch.from_numpy(v) for k, v in out.items()}, mlt)
            np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-6)
            np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-6)


@pytest.fixture(scope="module")
def rgbd_run(tmp_path_factory):
    """The RGB-D slice through both packages: depth test batches, the
    dual-stream model (cat fusion), depth refinement against the bank."""
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    syn = build_synth_bop(tmp_path_factory.mktemp("bop_rgbd"), n_images=3, seed=5)
    jmeta = syn["meta"]
    tmeta = DatasetMeta(name=jmeta.name, id2obj=dict(jmeta.id2obj),
                        width=jmeta.width, height=jmeta.height,
                        camera_matrix=jmeta.camera_matrix)
    cfg = tiny_cfg(**{"model.pose_net.num_classes": 2,
                      "model.pose_net.name": "gdrn_dstream_double_mask"})
    jm, params = jax_gdrn_params(cfg, seed=6)
    port = port_gdrn(cfg, params)
    bank = ModelBank.from_bop_models_dir(f"{syn['root']}/models", num_points=128,
                                         num_fps=8)

    def batches(bd, meta, it):
        by_im = bd.make_records_by_image(bd.index_bop_split(syn["split_dir"], meta))
        return list(it(by_im, bd.load_detections(syn["det_file"], meta),
                       batch_size=4, with_depth=True))

    kw = dict(input_res=64, output_res=16, with_depth_input=True)
    refine = dict(post_mode="depth_refine", depth_refine_iters=2)
    j_res = j_run(lambda p, b: jm.apply({"params": p}, **b), params,
                  batches(jbd, jmeta, j_iter), bank.extents, model_bank=syn["bank"],
                  **kw, **refine)
    t_batches = batches(tbd, tmeta, iter_test_batches)
    t_res = run_gdrn_inference(port, t_batches, bank.extents, model_bank=bank, **kw,
                               **refine)
    t_direct = run_gdrn_inference(port, t_batches, bank.extents, **kw)
    return dict(j=j_res, t=t_res, direct=t_direct, port=port, batches=t_batches,
                bank=bank, kw=kw)


def test_rgbd_depth_refine_rows_match_jax(rgbd_run):
    j_res, t_res = rgbd_run["j"], rgbd_run["t"]
    assert len(t_res) == len(j_res) == 6
    for a, b in zip(j_res, t_res):
        assert (a["scene_id"], a["im_id"], a["obj_id"]) == (b["scene_id"], b["im_id"],
                                                           b["obj_id"])
        np.testing.assert_allclose(b["R"], a["R"], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b["t"], a["t"], rtol=1e-4, atol=1e-4)
        assert np.isfinite(b["R"]).all() and np.isfinite(b["t"]).all()


def test_rgbd_depth_refine_changes_only_t(rgbd_run):
    moved = 0
    for a, b in zip(rgbd_run["direct"], rgbd_run["t"]):
        np.testing.assert_array_equal(a["R"], b["R"])
        moved += int(np.abs(a["t"] - b["t"]).max() > 1e-6)
    assert moved > 0


def test_rgbd_inputs_are_checked(rgbd_run):
    no_depth = [{k: v for k, v in b.items() if k != "depths"} for b in rgbd_run["batches"]]
    with pytest.raises(ValueError, match="depths"):
        run_gdrn_inference(rgbd_run["port"], no_depth, rgbd_run["bank"].extents,
                           **rgbd_run["kw"])
    with pytest.raises(ValueError, match="model bank"):
        run_gdrn_inference(rgbd_run["port"], rgbd_run["batches"],
                           rgbd_run["bank"].extents, post_mode="depth_refine",
                           **rgbd_run["kw"])
