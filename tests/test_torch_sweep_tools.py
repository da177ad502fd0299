"""Port parity: the sweep's host tools against the root JAX tools.

  * ``convert_dets``, ``merge_so_results`` and ``process_results_time`` write
    what ``tools/convert_dets.py``, ``tools/merge_so_results.py`` and
    ``tools/process_results_time.py`` write from the same files (bytes
    equal; the conversions' json objects equal);
  * ``strip_ckpt``: a port checkpoint (model, EMA, optimizer, step,
    generators) stripped to its weights or its EMA, which ``test_gdrn``'s
    ``weights_to_serve`` then serves;
  * ``compute_mask_miou`` on PNG and RLE-json masks: the root tool's IoU / F1;
  * ``vis_dataset`` on a ``tests/synth_utils.py::build_synth_bop`` split:
    the same panels, pixel for pixel, as the root tool's on the JAX
    package's records;
  * ``register_meta_file``, which the CLIs' ``--dataset-meta`` reads.
The sweep itself (subprocesses) is ``tests/test_torch_sweep.py``.
"""

import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.bop.inout import load_bop_results as t_load, save_bop_results as t_save
from gdrnpp_bop2022_torch.datasets.meta import DATASETS_META, register_meta_file
from gdrnpp_bop2022_torch.tools import (compute_mask_miou, convert_dets, merge_so_results,
                                        process_results_time, strip_ckpt, test_gdrn,
                                        vis_dataset)
from gdrnpp_bop2022_torch.utils import mask_rle
from synth_utils import K, build_synth_bop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

COCO = [
    {"scene_id": 2, "image_id": 7, "category_id": 5, "bbox": [10.0, 20.0, 30.0, 40.0],
     "score": 0.9, "time": 0.1},
    {"scene_id": 2, "image_id": 7, "category_id": 5, "bbox": [12.0, 21.0, 30.0, 40.0],
     "score": 0.4, "time": 0.1},
    {"scene_id": 3, "image_id": 1, "category_id": 1, "bbox": [0.0, 0.0, 5.0, 5.0], "score": 0.7},
]


def _rows(rs, n, scene=1):
    return [{"scene_id": scene, "im_id": int(rs.randint(0, 4)), "obj_id": int(rs.randint(1, 6)),
             "score": float(rs.rand()), "R": np.linalg.qr(rs.randn(3, 3))[0],
             "t": rs.uniform(-100, 900, 3), "time": float(rs.uniform(0.01, 0.5))}
            for _ in range(n)]


def test_convert_dets_equal_root(tmp_path):
    from tools import convert_dets as root
    for thr in (0.0, 0.5):
        assert convert_dets.coco_to_ours(COCO, thr) == root.coco_to_ours(COCO, thr)
    ours = convert_dets.coco_to_ours(COCO)
    assert convert_dets.ours_to_coco(ours) == root.ours_to_coco(ours)
    csv = str(tmp_path / "poses.csv")
    rows = _rows(np.random.RandomState(0), 6, scene=2)
    rows[0].update(im_id=7, obj_id=5)
    t_save(csv, rows)
    from gdrnpp_bop2022_tpu.bop.inout import load_bop_results
    assert convert_dets.combine_det_pose(ours, t_load(csv)) == \
        root.combine_det_pose(ours, load_bop_results(csv))
    src, dst = tmp_path / "coco.json", tmp_path / "ours.json"
    src.write_text(json.dumps(COCO))
    convert_dets.main(["coco2ours", str(src), str(dst)])
    assert json.loads(dst.read_text()) == root.coco_to_ours(COCO)
    out = tmp_path / "combined.json"
    convert_dets.main(["combine", str(dst), csv, str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(
        root.combine_det_pose(ours, load_bop_results(csv))))


def test_merge_and_times_equal_root(tmp_path, monkeypatch):
    import merge_so_results as root_merge
    import process_results_time as root_time
    rs = np.random.RandomState(1)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"so{i}.csv")
        t_save(p, _rows(rs, 5))
        paths.append(p)
    for norm in (True, False):
        a, b = str(tmp_path / f"port_{norm}.csv"), str(tmp_path / f"root_{norm}.csv")
        assert merge_so_results.merge_csvs(paths, a, norm) == root_merge.merge_csvs(paths, b, norm)
        assert open(a).read() == open(b).read()
    (tmp_path / "bad.csv").write_text("other,header\n1,2\n")
    with pytest.raises(ValueError, match="header"):
        merge_so_results.merge_csvs([paths[0], str(tmp_path / "bad.csv")], str(tmp_path / "x.csv"))
    a, b = str(tmp_path / "port_time.csv"), str(tmp_path / "root_time.csv")
    assert process_results_time.main([a, *paths]) == 15
    monkeypatch.setattr(sys, "argv", ["process_results_time.py", b, *paths])
    root_time.main()
    assert open(a).read() == open(b).read()
    times = {}
    for r in t_load(a):
        times.setdefault((r["scene_id"], r["im_id"]), set()).add(r["time"])
    assert all(len(v) == 1 for v in times.values())


class _State:
    """What CheckpointManager.save reads from a train state."""

    def __init__(self):
        self.model = torch.nn.Linear(3, 2)
        self.optimizer = torch.optim.SGD(self.model.parameters(), lr=0.1, momentum=0.9)
        self.model(torch.ones(1, 3)).sum().backward()
        self.optimizer.step()
        self.step = 7
        self.generators = {"loader": torch.Generator().manual_seed(3)}

    def ema_state_dict(self):
        return {k: torch.full_like(v, 0.5) for k, v in self.model.state_dict().items()}


def test_strip_ckpt_roundtrip(tmp_path):
    from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
    st = _State()
    ckpt_dir = str(tmp_path / "ckpt")
    CheckpointManager(ckpt_dir).save(st, 7)
    out = strip_ckpt.main(["--ckpt", ckpt_dir])
    assert out == ckpt_dir + "_wo_optim.pth"
    rel = torch.load(out)
    assert set(rel) == {"step", "model"} and rel["step"] == 7
    for k, v in st.model.state_dict().items():
        assert torch.equal(rel["model"][k], v)
    ema = str(tmp_path / "ema.pth")
    full = strip_ckpt.checkpoint_file(ckpt_dir)
    assert strip_ckpt.strip(full, ema, use_ema=True) == 7
    served = test_gdrn.weights_to_serve(torch.load(ema), ema_enabled=True)
    assert all((v == 0.5).all() for v in served.values())
    with pytest.raises(FileNotFoundError):
        strip_ckpt.checkpoint_file(ckpt_dir, step=3)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("bopv")
    syn = build_synth_bop(root / "synthv", split="test", n_images=3, seed=11)
    meta = tmp_path_factory.mktemp("meta") / "synthv.json"
    meta.write_text(json.dumps({"name": "synthv", "id2obj": {"1": "cube", "2": "small_cube"},
                                "width": 160, "height": 120,
                                "camera_matrix": K.ravel().tolist(), "sym_objs": ["cube"]}))
    return root, syn, str(meta)


def test_register_meta_file(synth):
    _, syn, meta = synth
    m = register_meta_file(meta)
    assert DATASETS_META["synthv"] is m and m.id2obj == syn["meta"].id2obj
    assert m.sym_objs == ("cube",) and m.camera_matrix.shape == (3, 3)
    np.testing.assert_array_equal(m.camera_matrix, syn["meta"].camera_matrix)


def test_compute_mask_miou_equals_root(synth, tmp_path):
    from tools import compute_mask_miou as root
    _, syn, _ = synth
    masks = sorted(os.listdir(os.path.join(syn["split_dir"], "000001", "mask_visib")))
    pred, gt = tmp_path / "pred", tmp_path / "gt"
    pred.mkdir()
    gt.mkdir()
    for i, name in enumerate(masks):
        m = cv2.imread(os.path.join(syn["split_dir"], "000001", "mask_visib", name), 0) > 127
        p = np.roll(m, i, axis=1)                        # shifted predictions
        cv2.imwrite(str(pred / name), p.astype(np.uint8) * 255)
        cv2.imwrite(str(gt / name), m.astype(np.uint8) * 255)
        stem = name[:-4] + ".json"
        for d, mm in ((pred, p), (gt, m)):
            rle = mask_rle.encode(mm)
            (d / stem).write_text(json.dumps({"size": rle["size"],
                                              "counts": rle["counts"].decode()}))
    got = compute_mask_miou.mask_miou(str(pred), str(gt))
    assert len(got) == 2 * len(masks) and got[masks[0]] == (1.0, 1.0)
    for name, v in got.items():
        assert v == root.iou_f1(root.load_mask_any(str(pred / name)),
                                root.load_mask_any(str(gt / name)))


def test_vis_dataset_equals_root(synth, tmp_path):
    from gdrnpp_bop2022_tpu.bop.models3d import load_models_info as j_info
    from gdrnpp_bop2022_tpu.config import Config as JConfig
    from gdrnpp_bop2022_tpu.datasets.bop_data import index_bop_split as j_index
    from tools import vis_dataset as root
    root_dir, syn, meta = synth
    register_meta_file(meta)
    outs = vis_dataset.main(["--dataset", "synthv_test", "--num-images", "2", "--dzi",
                             "--out", str(tmp_path / "port"),
                             "--opts", f"datasets.root={str(root_dir)!r}"])
    want = root.vis_records(j_index(syn["split_dir"], syn["meta"]),
                            j_info(os.path.join(syn["root"], "models")), 2,
                            str(tmp_path / "root"), dzi_cfg=JConfig().input)
    assert len(outs) == len(want) == 2
    for a, b in zip(outs, want):
        assert os.path.basename(a) == os.path.basename(b)
        np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
