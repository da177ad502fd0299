"""Port parity: the BOP scorer (``eval/scorer.py``) and the port's
``score_csv`` CLI against the JAX package.

Fixtures: the randomized multi-instance splits of
tests/test_scorer_toolkit.py (symmetric object with an off-centre axis,
per-threshold greedy matching), and cube scenes with test depth in which
pairs fall in every VSD render mode (window, image-grid buckets, the full
image). Every key the JAX scorer returns (AR, AR_vsd/mssd/mspd, the aux
recalls, AUCs and precision tables) agrees within 1e-6, with the port on the
CPU; ``match_count`` agrees exactly.
"""

import inspect
import json

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.eval import scorer as JS
from gdrnpp_bop2022_torch.eval import scorer as TS
from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
from test_eval_grid import _CubeBank
from test_scorer_toolkit import _random_fixture, _TinyBank

AR_TOL = 1e-6


def _assert_same_scores(got, want):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= AR_TOL, (k, got[k], want[k])


def test_match_count_matches_jax():
    rs = np.random.RandomState(0)
    for _ in range(200):
        table = rs.uniform(0, 1, (rs.randint(1, 6), rs.randint(1, 6)))
        th = rs.uniform(0.1, 0.9)
        assert TS.match_count(table, th) == JS.match_count(table, th)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_toolkit_fixture_scores_match_jax(seed):
    bank, gts, ests = _random_fixture(seed)
    kw = dict(im_width=128, errors=("mssd", "mspd"))
    want = JS.score_bop_results(ests, gts, bank, **kw)
    got = TS.score_bop_results(ests, gts, bank, device="cpu", **kw)
    _assert_same_scores(got, want)
    assert 0 < got["AR_mssd"] < 1 and "prec_ad_10" in got and "auc_adi_10cm" in got


@pytest.mark.parametrize("kw", [dict(n_top=1), dict(sym_obj_labels=[1]),
                                dict(visib_gt_min=0.5, eval_precision=False)],
                         ids=["n_top", "sym_obj_labels", "visib_gt_min"])
def test_scorer_options_match_jax(kw):
    bank, gts, ests = _random_fixture(4)
    gts = [{**g, "visib_fract": 0.3 if i % 3 == 0 else 1.0} for i, g in enumerate(gts)]
    kw = dict(im_width=128, errors=("mssd", "mspd"), **kw)
    _assert_same_scores(TS.score_bop_results(ests, gts, bank, device="cpu", **kw),
                        JS.score_bop_results(ests, gts, bank, **kw))


def _render_np(bank, R, t, K, H, W):
    t_ = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    d, _ = render_depth_xyz_batch(t_(bank.verts), t_(bank.faces).int(), t_(R)[None],
                                  t_(t)[None], t_(K)[None], H, W, need_xyz=False)
    return d[0].numpy()


def _vsd_scene():
    """Cube targets on 240x320 and 96x128 test images: near estimates (the
    128x128 bucket or the window), a far one (the 240x256 bucket; the
    96x128 image has no bucket smaller than itself, so the full image),
    targets with two GT and three estimates, a GT without an estimate."""
    bank = _CubeBank()
    rs = np.random.RandomState(3)
    gts, ests, depths = [], [], {}
    for im, (H, W, f) in enumerate(((240, 320, 300.0), (96, 128, 140.0), (240, 320, 300.0))):
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
        depth = np.zeros((H, W), np.float32)
        for k in range(2 if im != 1 else 1):
            R = np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32)
            R *= np.sign(np.linalg.det(R))
            t = np.array([rs.uniform(-0.05, 0.05), rs.uniform(-0.03, 0.03),
                          rs.uniform(0.4, 0.6)], np.float32)
            d = _render_np(bank, R, t, K, H, W)
            depth = np.where((d > 0) & ((depth == 0) | (d < depth)), d, depth)
            gts.append({"scene_id": 1, "im_id": im, "obj_id": 1, "R": R, "t": t,
                        "visib_fract": 1.0})
            if im == 2 and k == 1:
                continue                                  # an undetected GT
            for dz, sc in ((rs.uniform(-0.01, 0.01), 0.9), (0.02, 0.5), (0.3, 0.95)):
                dt = np.array([rs.uniform(-0.004, 0.004), 0, dz], np.float32)
                if dz == 0.3:
                    dt = np.array([0.12, 0.05, -0.15], np.float32)   # a far miss
                ests.append({"scene_id": 1, "im_id": im, "obj_id": 1, "R": R, "t": t + dt,
                             "score": sc + 0.01 * k, "K": K})
        depth[:, : W // 8] = np.where(depth[:, : W // 8] > 0, 0.3, 0.0)   # an occluder
        depths[im] = depth
    return bank, gts, ests, depths


@pytest.mark.parametrize("vsd_mode", ["full", "auto", "window"])
def test_vsd_scores_match_jax(vsd_mode):
    bank, gts, ests, depths = _vsd_scene()
    kw = dict(im_width=320, errors=("vsd", "mssd", "mspd"), vsd_mode=vsd_mode,
              depth_test_getter=lambda s, i: depths[i])
    stats = {}
    got = TS.score_bop_results(ests, gts, bank, device="cpu", stats=stats, **kw)
    _assert_same_scores(got, JS.score_bop_results(ests, gts, bank, **kw))
    assert 0 < got["AR_vsd"] < 1
    modes = {k.split()[0] for k in stats["vsd_pairs"]}
    if vsd_mode != "auto":
        assert modes == {"full": {"bbox", "full"}, "window": {"window"}}[vsd_mode], modes
    assert sum(stats["vsd_pairs"].values()) == stats["n_pairs"]
    assert set(stats["seconds"]) >= {"pairs", "errors", "vsd", "matching", "aux", "total"}
    assert stats["targets_per_s"] > 0 and stats["device"] == "cpu"


def test_vsd_renders_go_through_render():
    bank, gts, ests, depths = _vsd_scene()
    calls = []

    def counting(*a, need_xyz=True):
        calls.append((a[5], a[6], need_xyz))
        return render_depth_xyz_batch(*a, need_xyz=need_xyz)

    TS.score_bop_results(ests, gts, bank, im_width=320, errors=("vsd",), device="cpu",
                         depth_test_getter=lambda s, i: depths[i], render=counting)
    assert calls and not any(c[2] for c in calls)
    assert {(128, 128), (240, 256), (96, 128)} == {c[:2] for c in calls}


def test_vsd_missing_depth_skips_target():
    bank, gts, ests = _random_fixture(3, n_images=2, n_inst=1)
    perfect = [{**g, "score": 1.0} for g in gts]
    s = TS.score_bop_results(perfect, gts, bank, im_width=128, errors=("mssd", "vsd"),
                             depth_test_getter=lambda s, i: None, device="cpu")
    assert "AR_vsd" not in s and s["AR_mssd"] == 1.0


def test_helpers_match_jax():
    bank = _TinyBank()
    _, gts, ests = _random_fixture(5)
    g = [x for x in gts if x["im_id"] == 0 and x["obj_id"] == 1]
    e = [x for x in ests if x["im_id"] == 0 and x["obj_id"] == 1]
    for name in ("mssd", "mspd"):
        want = JS._error_table(e, g, name, bank.points[0], bank.sym_rotations[0],
                               bank.sym_translations[0])
        got = TS._error_table(e, g, name, bank.points[0], bank.sym_rotations[0],
                              bank.sym_translations[0], device="cpu")
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    errs = np.random.RandomState(0).uniform(0, 0.15, 50)
    assert TS.auc_of_errors(errs) == JS.auc_of_errors(errs)
    kw = dict(im_width=128, errors=("mssd",))
    want = JS.per_object_scores(ests, gts, bank, **kw)
    got = TS.per_object_scores(ests, gts, bank, device="cpu", **kw)
    assert set(got) == set(want)
    for k in want:
        if k == "weighted_mean_AR":
            assert abs(got[k] - want[k]) <= AR_TOL
        else:
            _assert_same_scores(got[k], want[k])


def test_score_csv_cli_matches_jax(tmp_path, capsys):
    """The port's CLI with --device cpu on a synthetic BOP split (two cubes
    in three 160x120 images, depth PNGs) against the JAX package's
    score_bop_results on the same files."""
    from gdrnpp_bop2022_tpu.bop.inout import load_bop_results as j_load
    from gdrnpp_bop2022_tpu.datasets.bop_data import index_bop_split as j_index
    from gdrnpp_bop2022_tpu.datasets.bop_data import load_depth as j_load_depth
    from gdrnpp_bop2022_torch.bop.inout import save_bop_results
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
    from gdrnpp_bop2022_torch.tools import score_csv
    from synth_utils import build_synth_bop

    syn = build_synth_bop(tmp_path / "synth", n_images=3, seed=2)
    jm = syn["meta"]
    register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                              height=jm.height, camera_matrix=jm.camera_matrix))
    rs = np.random.RandomState(8)
    rows = []
    for g in syn["gt_rows"]:
        for dz in (0.0, rs.uniform(0.005, 0.03)):
            rows.append({**g, "t": (g["t"] + np.array([0, 0.002, dz])) * 1000.0,
                         "score": 1.0 - dz, "time": 0.1})
    csv = tmp_path / "poses.csv"
    save_bop_results(str(csv), rows)
    got = score_csv.main(["--csv", str(csv), "--dataset", "synth", "--root", str(tmp_path),
                          "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == got

    bank = ModelBank.from_bop_models_dir(str(tmp_path / "synth" / "models"))
    results = j_load(str(csv))
    for r in results:
        r["t"] = np.asarray(r["t"]) / 1000.0
        r["K"] = jm.camera_matrix.astype(np.float32)
    records = j_index(str(tmp_path / "synth" / "test"), jm)
    gt_rows = [{"scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
                "R": r.pose[:, :3], "t": r.pose[:, 3], "visib_fract": r.visib_fract}
               for r in records]
    by_key = {(r.scene_id, r.im_id): r for r in records}
    want = JS.score_bop_results(
        results, gt_rows, bank, im_width=jm.width, vsd_mode="full",
        depth_test_getter=lambda s, i: j_load_depth(by_key[(s, i)].depth_path,
                                                    by_key[(s, i)].depth_scale, 1000.0))
    _assert_same_scores(got, want)
    assert 0 < got["AR_vsd"] < 1 and 0 < got["AR"] < 1


def test_entry_points_default_to_the_card():
    from gdrnpp_bop2022_torch.tools import score_csv, test_gdrn
    assert inspect.signature(TS.score_bop_results).parameters["device"].default == "cuda"
    for mod in (score_csv, test_gdrn):
        assert '"--device", default="cuda"' in inspect.getsource(mod.main)


@pytest.mark.gpu
def test_scores_on_the_card_match_the_cpu():
    """The scorer on the card (B2 renders) against the port on the CPU, and
    against itself with the plain rasterizer on the card (exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B2")
    bank, gts, ests, depths = _vsd_scene()
    kw = dict(im_width=320, errors=("vsd", "mssd", "mspd"),
              depth_test_getter=lambda s, i: depths[i])
    card = TS.score_bop_results(ests, gts, bank, device="cuda", **kw)
    _assert_same_scores(card, TS.score_bop_results(ests, gts, bank, device="cpu", **kw))
    assert card == TS.score_bop_results(ests, gts, bank, device="cuda",
                                        render=render_depth_xyz_batch, **kw)
