"""The port's two-stage path on the CPU: image -> YOLOX -> handoff json -> GDRN.

On a synthetic BOP split (3 images of 160x120, two cubes each):
  * ``python -m gdrnpp_bop2022_torch.tools.test_yolox --device cpu`` (yolox_s
    at 64x64, GN, fp32 on the CPU, batches of 2 with the last padded, no TTA) writes the
    handoff json that the JAX pipeline (its letterbox, model, NMS and
    ``detections_to_bop_json``) writes at the same weights: the same images
    and rows, each with its obj_id, its score within 1e-4 and its box within
    1e-2 px (the models' outputs differ by ~3e-5 of their largest magnitude);
    its recipe mode resolves the knobs as the JAX CLI's ``resolve_eval_cfg``;
    with TTA it runs and writes a json of the same form;
  * that json feeds the port's ``test_gdrn`` (``model.load_dets_test=True``);
  * ``demo_yolox --save-dets`` then ``demo_gdrn --dets``, and ``demo_gdrn``
    with the detector inline, run on two images and draw them;
  * without ``--device cpu`` the CLIs need a card.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.datasets.bop_data import index_bop_split, load_image
from gdrnpp_bop2022_tpu.datasets.yolox_loader import letterbox
from gdrnpp_bop2022_tpu.eval.detection_eval import detections_to_bop_json
from gdrnpp_bop2022_tpu.models.yolox.head import flatten_outputs
from gdrnpp_bop2022_tpu.models.yolox.yolox import postprocess_nms
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.tools import demo_gdrn, demo_yolox, test_gdrn, test_yolox
from gdrnpp_bop2022_torch.utils.weights import yolox_state_dict_from_flax
from synth_utils import build_synth_bop
from test_torch_tools import TINY
from torch_parity_utils import assert_rows_match, jax_yolox

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 64


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop2s")
    syn = build_synth_bop(root / "synth", n_images=3, seed=7)
    jm = syn["meta"]
    register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                              height=jm.height, camera_matrix=jm.camera_matrix))
    # yolox_s (dep 0.33, wid 0.5), GN, from a seed; its .pth for the port
    jmodel, params, _ = jax_yolox("GN", False, 0.5, S, seed=2, nc=2)
    wpath = root / "yolox_s.pth"
    torch.save(yolox_state_dict_from_flax(params), wpath)
    return root, syn, jmodel, params, str(wpath)


def _jax_handoff(syn, jmodel, params, batch=2):
    """The JAX package's pipeline (tools/test_yolox.py without TTA) in fp32."""
    @jax.jit
    def infer(imgs):
        flat, grids, st = flatten_outputs(jmodel.apply({"params": params}, imgs), (8, 16, 32))
        return postprocess_nms(flat, grids, st, conf_thr=0.01, nms_thr=0.65)

    by_img = {}
    for r in index_bop_split(syn["split_dir"], syn["meta"]):
        by_img.setdefault(r.scene_im_id, r.rgb_path)
    keys = sorted(by_img)
    per_image, scales = {}, {}
    for b0 in range(0, len(keys), batch):
        bk = keys[b0:b0 + batch]
        canv = [letterbox(load_image(by_img[k]), S) for k in bk]
        imgs = [c for c, _ in canv] + [canv[-1][0]] * (batch - len(bk))
        det = jax.device_get(infer(jnp.asarray(np.stack(imgs), jnp.float32)))
        for i, k in enumerate(bk):
            per_image[k] = {n: v[i] for n, v in det.items()}
            scales[k] = canv[i][1]
    return detections_to_bop_json(per_image, syn["meta"].label_to_obj_id(), scale_factors=scales)


def _yolox_args(root, wpath, out, *extra):
    return ["--dataset", "synth", "--root", str(root), "--size", "yolox_s",
            "--input-size", str(S), "--weights", wpath, "--batch-size", "2",
            "--device", "cpu", "--out", str(out), *extra]


def _rows(rows):
    return ([r["obj_id"] for r in rows], [r["score"] for r in rows],
            np.array([r["bbox_est"] for r in rows]))


@pytest.fixture(scope="module")
def handoff(synth, tmp_path_factory):
    root, syn, jmodel, params, wpath = synth
    out = tmp_path_factory.mktemp("yolox_out")
    got, m, stats = test_yolox.main(_yolox_args(root, wpath, out))
    path = out / "yolox_synth_test_bboxes.json"
    assert json.loads(path.read_text()) == got
    return got, str(path), m, stats


def test_test_yolox_writes_the_jax_pipelines_handoff(synth, handoff):
    root, syn, jmodel, params, _ = synth
    got, _, m, stats = handoff
    want = _jax_handoff(syn, jmodel, params)
    assert sorted(got) == sorted(want) == ["1/0", "1/1", "1/2"]
    for k in want:
        # every anchor is a candidate (A = 84 < 400) and fewer than 100 rows
        # survive, so no cut can drop a near-tied row
        assert 0 < len(want[k]) < 100
        assert_rows_match(*_rows(want[k]), *_rows(got[k]), score_tol=1e-4, box_tol=1e-2)
    assert stats["n_images"] == 3 and stats["n_batches"] == 2
    assert 0.0 <= m["mAP"] <= m["AP50"] <= 1.0


def test_test_yolox_recipe_and_tta(synth, tmp_path):
    root, _, _, _, wpath = synth
    sys.path.insert(0, REPO)
    from tools.test_yolox import resolve_eval_cfg as jax_resolve

    def ns(**over):
        base = dict(config=None, opts=[], dataset=None, size=None, input_size=None,
                    norm=None, conf_thr=None, nms_thr=None, tta=None, tta_scales=None)
        return argparse.Namespace(**{**base, **over})

    cases = [dict(config="ycbv"), dict(config="tless_real_pbr", norm="BN"),
             dict(config="ycbv", tta=False, conf_thr=0.2, opts=["test.nms_thr=0.7"]),
             dict(dataset="tless"), dict(dataset="lmo", tta=True, tta_scales="1,0.5")]
    for c in cases:
        jc = dict(c, config=os.path.join(REPO, "configs", "yolox", c["config"] + ".py")) \
            if "config" in c else c
        (cfg, conf), (jcfg, jconf) = test_yolox.resolve_eval_cfg(ns(**c)), jax_resolve(ns(**jc))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg) and conf == jconf, c

    got, _, stats = test_yolox.main(_yolox_args(root, wpath, tmp_path, "--tta",
                                                "--tta-scales", "1,0.75,1.25"))
    assert sorted(got) == ["1/0", "1/1", "1/2"] and stats["n_batches"] == 2
    for rows in got.values():
        assert 0 < len(rows) <= 100
        assert all(r["obj_id"] in (1, 2) and np.isfinite(r["bbox_est"]).all() for r in rows)


def test_handoff_feeds_test_gdrn(synth, handoff, tmp_path):
    root = synth[0]
    _, path, _, _ = handoff
    opts = TINY + [f"datasets.root={str(root)!r}", "datasets.test=('synth_test',)",
                   "model.load_dets_test=True", f"datasets.det_files_test=({path!r},)",
                   f"output_dir={str(tmp_path)!r}", "val.save_results_only=True"]
    results, scores = test_gdrn.main(["--opts", *opts, "--seed", "0", "--device", "cpu"])
    assert scores is None
    # top-1 per object and image: both cubes of every image were detected
    # by the random detector at conf 0.01
    per_im = {(r["scene_id"], r["im_id"]) for r in results}
    assert len(results) == 6 and len(per_im) == 3
    assert all(np.isfinite(r["t"]).all() for r in results)
    assert (tmp_path / "inference" / "synth_test" / "poses.csv").exists()


def test_demos_on_two_images(synth, tmp_path):
    root, syn, _, _, wpath = synth
    rgb = os.path.join(syn["split_dir"], "000001", "rgb")
    imgs = [os.path.join(rgb, f"{i:06d}.png") for i in range(2)]
    dets_json = tmp_path / "dets.json"
    dets = demo_yolox.main(["--dataset", "synth", "--images", os.path.join(rgb, "00000[01].png"),
                            "--size", "yolox_s", "--input-size", str(S), "--conf-thr", "0.35",
                            "--out", str(tmp_path / "det"), "--save-dets", str(dets_json),
                            "--weights", wpath, "--device", "cpu"])
    assert sorted(dets) == ["000000", "000001"] and all(dets.values())
    assert json.loads(dets_json.read_text()) == dets
    assert (tmp_path / "det" / "000000_det.png").exists()

    gdrn = ["--opts", *TINY, f"datasets.root={str(root)!r}", "val.dataset_name='synth'",
            "--seed", "0", "--device", "cpu"]
    for det_src in (["--dets", str(dets_json)],
                    ["--yolox-weights", wpath, "--yolox-size", "yolox_s",
                     "--yolox-input-size", str(S), "--conf-thr", "0.35"]):
        out = tmp_path / det_src[0].strip("-")
        results, written = demo_gdrn.main(["--images", *imgs, *det_src, "--out", str(out),
                                           *gdrn])
        # the inline detector is demo_yolox's: the same boxes, so the same ROIs
        assert len(results) == sum(len(v) for v in dets.values())
        assert sorted(os.path.basename(w) for w in written) == ["000000.png", "000001.png"]
        assert all(np.isfinite(r["t"]).all() for r in results)


def test_clis_need_a_card_without_device_cpu(synth, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    root, _, _, _, wpath = synth
    args = _yolox_args(root, wpath, tmp_path)
    i = args.index("--device")
    with pytest.raises((RuntimeError, AssertionError)):
        test_yolox.main(args[:i] + args[i + 2:])
