"""Port parity: detection evaluation and the stage-1 -> stage-2 handoff.

``detections_to_bop_json``, ``coco_map`` and ``_voc_ap`` (numpy in both
packages) give equal results on random detections (perfect ones score
100/101 in both: the JAX package's 101-point interpolation reads precision 0
at recall 1.0); the letterbox and
``det_records_from_instances`` equal the JAX package's on a synthetic BOP
split; ``evaluate_yolox_records`` runs the port's detector over that split
as the JAX function runs its own (a GN model at dep 0.33 / wid 0.125, fp32,
the same weights): equal mAP and AP50.
"""

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.datasets import bop_data as jbd
from gdrnpp_bop2022_tpu.datasets import yolox_loader as jyl
from gdrnpp_bop2022_tpu.eval import detection_eval as jde
from gdrnpp_bop2022_torch.datasets import bop_data as tbd
from gdrnpp_bop2022_torch.datasets import yolox_loader as tyl
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.eval import detection_eval as tde
from gdrnpp_bop2022_torch.utils.weights import yolox_state_dict_from_flax
from synth_utils import build_synth_bop
from torch_parity_utils import jax_yolox, port_yolox


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    syn = build_synth_bop(tmp_path_factory.mktemp("det") / "synth", n_images=3, seed=11)
    jm = syn["meta"]
    meta = register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                                     height=jm.height, camera_matrix=jm.camera_matrix))
    return syn, meta


def _random_dets(rs, n_img=4, n_cls=3, n_det=12):
    dets, gts = {}, {}
    for i in range(n_img):
        g = rs.uniform(0, 100, (5, 2))
        gb = np.concatenate([g, g + rs.uniform(10, 60, (5, 2))], 1)
        gl = rs.randint(0, n_cls, 5)
        gts[f"1/{i}"] = [{"bbox_xyxy": b.tolist(), "label": int(lab)} for b, lab in zip(gb, gl)]
        # half the detections near a GT box, half anywhere
        pick = rs.randint(0, 5, n_det)
        db = gb[pick] + rs.normal(0, 4, (n_det, 4))
        db[1::2] = np.concatenate([g[:1] + rs.uniform(0, 80, (1, 2)),
                                   g[:1] + rs.uniform(90, 150, (1, 2))], 1)
        dl = np.where(rs.uniform(size=n_det) < 0.8, gl[pick], rs.randint(0, n_cls, n_det))
        dets[f"1/{i}"] = [{"bbox_xyxy": b.tolist(), "label": int(lab), "score": float(s)}
                          for b, lab, s in zip(db, dl, rs.uniform(0, 1, n_det))]
    return dets, gts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_map_and_voc_ap_match_jax(seed):
    dets, gts = _random_dets(np.random.RandomState(seed))
    want = jde.coco_map(dets, gts, num_classes=3)
    assert 0.0 < want["mAP"] < want["AP50"] <= 1.0
    assert tde.coco_map(dets, gts, num_classes=3) == want
    perfect = {k: [{**g, "score": 0.9} for g in v] for k, v in gts.items()}
    assert tde.coco_map(perfect, gts, 3) == jde.coco_map(perfect, gts, 3)
    # perfect detections score 100/101 in both: the last of the 101 recall
    # points (1.0) reads the 0 precision appended after recall 1.0
    assert tde.coco_map(perfect, gts, 3) == pytest.approx({"mAP": 100 / 101, "AP50": 100 / 101})
    rs = np.random.RandomState(seed)
    rec = np.sort(rs.uniform(0, 1, 20))
    prec = rs.uniform(0, 1, 20)
    assert tde._voc_ap(rec, prec) == jde._voc_ap(rec, prec)


def test_handoff_json_matches_jax():
    rs = np.random.RandomState(3)
    per_image, scales = {}, {}
    for i in range(3):
        valid = rs.uniform(size=10) < 0.7
        scores = np.where(rs.uniform(size=10) < 0.8, rs.uniform(0, 1, 10), 0.0)
        per_image[f"2/{i}"] = {
            "boxes_xyxy": rs.uniform(0, 300, (10, 4)).astype(np.float32),
            "scores": scores.astype(np.float32), "labels": rs.randint(0, 3, 10),
            "valid": valid, "time": 0.01 * i}
        scales[f"2/{i}"] = rs.uniform(0.5, 2.0)
    l2o = {0: 1, 1: 5, 2: 9}
    for sf in (None, scales):
        want = jde.detections_to_bop_json(per_image, l2o, scale_factors=sf)
        assert want and tde.detections_to_bop_json(per_image, l2o, scale_factors=sf) == want


@pytest.mark.parametrize("hw,size", [((120, 160), 64), ((480, 640), 640), ((300, 200), 128)])
def test_letterbox_matches_jax(hw, size):
    img = np.random.RandomState(0).randint(0, 256, hw + (3,)).astype(np.uint8)
    want, r_want = jyl.letterbox(img, size)
    got, r_got = tyl.letterbox(img, size)
    assert r_got == r_want and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_det_records_and_evaluation_match_jax(synth):
    syn, meta = synth
    jrec = jyl.det_records_from_instances(jbd.index_bop_split(syn["split_dir"], syn["meta"]))
    trec = tyl.det_records_from_instances(tbd.index_bop_split(syn["split_dir"], meta))
    assert len(trec) == len(jrec) == 3
    for a, b in zip(jrec, trec):
        assert a.rgb_path == b.rgb_path
        np.testing.assert_array_equal(a.boxes, b.boxes)
        np.testing.assert_array_equal(a.labels, b.labels)

    jm, params, _ = jax_yolox("GN", False, 0.125, 64, seed=5, nc=2)
    kw = dict(input_size=64, num_classes=2, conf_thr=0.05, max_dets=8, batch_size=2)
    want = jde.evaluate_yolox_records(jm, {"params": params}, jrec, **kw)
    m = port_yolox("GN", False, 0.125, yolox_state_dict_from_flax(params), nc=2)
    with torch.no_grad():
        got = tde.evaluate_yolox_records(m, trec, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
