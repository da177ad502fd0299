"""The demos' other sources, on the CPU (no JAX: the port's own paths).

On a synthetic RGB-D BOP split (3 images of 160x120, two cubes each, depth
PNGs at 1e-4 m):
  * ``demo_gdrn --camera 0 --max-frames 2`` with ``cv2.VideoCapture``
    replaced by a fake camera over the split's frames (BGR, channels made
    distinct): two frames named camera_000000.png / _000001.png are served
    and drawn, each frame flipped to RGB;
  * ``demo_gdrn --depth-refine --depth-images ... --cam-K ...`` equals
    ``run_gdrn_inference(post_mode="depth_refine")`` over the split's own
    index (``iter_test_batches(with_depth=True)``) on the same detections
    and weights: R and t bit for bit (the same device work on the same
    inputs), and the refined t differ from the direct ones; the flag's
    preconditions (depth images, file input, an RGB model) raise;
  * ``demo_yolox`` with a camera index in ``--images``, ``--max-frames`` and
    ``--register FILE`` (a python file that registers the dataset it names).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.bop.models3d import ModelBank
from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split, load_detections, load_image,
                                                    make_records_by_image)
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, get_meta, register_meta
from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
from gdrnpp_bop2022_torch.engine.inference import run_gdrn_inference
from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
from gdrnpp_bop2022_torch.tools import demo_gdrn, demo_yolox
from gdrnpp_bop2022_torch.tools.test_gdrn import load_config
from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
from synth_utils import build_synth_bop
from test_torch_tools import TINY


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("bopdemo")
    syn = build_synth_bop(root / "synthdemo", n_images=3, seed=11)
    jm = syn["meta"]
    meta = register_meta(DatasetMeta(name="synthdemo", id2obj=dict(jm.id2obj), width=jm.width,
                                     height=jm.height, camera_matrix=jm.camera_matrix))
    rgb_dir = os.path.join(syn["split_dir"], "000001", "rgb")
    frames = [load_image(os.path.join(rgb_dir, f"{i:06d}.png")) for i in range(3)]
    # distinct channels, so a missed BGR -> RGB flip shows
    frames = [np.ascontiguousarray(np.stack([f[..., 0], f[..., 1] // 2, f[..., 2] // 4], -1))
              for f in frames]
    with open(syn["det_file"]) as f:
        by_key = json.load(f)                                # "1/<im_id>" -> rows
    return root, syn, meta, frames, by_key


class FakeCapture:
    """cv2.VideoCapture over a list of RGB frames, returned as BGR."""
    frames: list = []
    opened: list = []

    def __init__(self, index):
        FakeCapture.opened.append(index)
        self.i = 0

    def isOpened(self):
        return True

    def read(self):
        if self.i >= len(self.frames):
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1][..., ::-1].copy()

    def release(self):
        pass


def _gdrn_args(root):
    return ["--opts", *TINY, f"datasets.root={str(root)!r}", "val.dataset_name='synthdemo'",
            "--seed", "0", "--device", "cpu"]


def test_camera_frames_are_rgb_and_capped(synth, monkeypatch, tmp_path):
    root, syn, _, frames, by_key = synth
    monkeypatch.setattr(FakeCapture, "frames", frames)
    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    got = list(demo_gdrn.camera_frames(0, 2))
    assert [n for n, _ in got] == ["camera_000000.png", "camera_000001.png"]
    for (_, f), want in zip(got, frames):
        np.testing.assert_array_equal(f, want)

    dets = tmp_path / "cam_dets.json"
    dets.write_text(json.dumps({f"camera_{i:06d}": by_key[f"1/{i}"] for i in range(3)}))
    results, written = demo_gdrn.main(["--camera", "0", "--max-frames", "2", "--dets",
                                       str(dets), "--out", str(tmp_path / "out"),
                                       *_gdrn_args(root)])
    assert sorted(os.path.basename(w) for w in written) == ["camera_000000.png",
                                                            "camera_000001.png"]
    assert sorted({r["im_id"] for r in results}) == [0, 1]
    assert len(results) == 4 and all(np.isfinite(r["t"]).all() for r in results)


def _reference(root, syn, cfg):
    """run_gdrn_inference(post_mode="depth_refine") over the split's own
    index and its detections file."""
    syn_meta = get_meta("synthdemo")
    by_im = make_records_by_image(index_bop_split(syn["split_dir"], syn_meta))
    dets = load_detections(syn["det_file"], syn_meta)
    model = build_gdrn(cfg, device="cpu")
    model.load_state_dict(seeded_state_dict(model, 0))
    pc = cfg.model.pose_net
    bank = ModelBank.from_bop_models_dir(syn_meta.models_dir(str(root)),
                                         num_fps=pc.geo_head.num_regions)
    return run_gdrn_inference(
        model, iter_test_batches(by_im, dets, batch_size=64, with_depth=True,
                                 depth_factor=syn_meta.depth_factor),
        bank.extents, input_res=pc.input_res, output_res=pc.output_res,
        pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std, post_mode="depth_refine",
        model_bank=bank, mask_loss_type=pc.loss.mask_loss_type,
        coord_2d_type=pc.pnp_net.coord_2d_type)


def test_depth_refine_equals_run_gdrn_inference(synth, tmp_path):
    root, syn, meta, _, by_key = synth
    sdir = os.path.join(syn["split_dir"], "000001")
    dets = tmp_path / "dets.json"
    dets.write_text(json.dumps({f"{i:06d}": by_key[f"1/{i}"] for i in range(3)}))
    K = [str(v) for v in np.asarray(meta.camera_matrix, np.float64).ravel()]
    args = ["--images", os.path.join(sdir, "rgb", "*.png"), "--dets", str(dets),
            "--cam-K", *K, *_gdrn_args(root)]
    refined, _ = demo_gdrn.main([*args, "--depth-images", os.path.join(sdir, "depth", "*.png"),
                                 "--depth-scale", "10000", "--depth-refine",
                                 "--depth-refine-iters", "2", "--out", str(tmp_path / "dr")])
    direct, _ = demo_gdrn.main([*args, "--out", str(tmp_path / "direct")])
    cfg = replace_cfg(load_config("default"),
                      parse_opts([*TINY, f"datasets.root={str(root)!r}"]))
    want = _reference(root, syn, cfg)
    key = lambda r: (r["im_id"], r["obj_id"])     # noqa: E731
    assert len(refined) == len(want) == 6
    got, exp, plain = (sorted(x, key=key) for x in (refined, want, direct))
    moved = 0.0
    for g, w, p in zip(got, exp, plain):
        assert key(g) == key(w) == key(p)
        np.testing.assert_array_equal(g["R"], w["R"])
        np.testing.assert_array_equal(g["t"], w["t"])
        np.testing.assert_array_equal(g["R"], p["R"])
        moved = max(moved, float(np.abs(g["t"] - p["t"]).max()))
    assert moved > 1e-4, moved


def test_depth_refine_preconditions(synth, tmp_path):
    root, syn, _, _, _ = synth
    rgb = os.path.join(syn["split_dir"], "000001", "rgb", "*.png")
    with pytest.raises(SystemExit):
        demo_gdrn.main(["--images", rgb, "--depth-refine", "--dets", "x.json",
                        *_gdrn_args(root)])
    with pytest.raises(SystemExit):
        demo_gdrn.main(["--camera", "0", "--depth-refine", "--depth-images", rgb,
                        "--dets", "x.json", *_gdrn_args(root)])
    with pytest.raises(SystemExit, match="RGB models"):
        demo_gdrn.main(["--config", "ycbv_convnext_base_rgbd", "--images", rgb,
                        "--dets", "x.json", "--out", str(tmp_path), *_gdrn_args(root)])


def test_demo_yolox_camera_max_frames_register(synth, monkeypatch, tmp_path):
    _, syn, meta, frames, _ = synth
    monkeypatch.setattr(FakeCapture, "frames", frames)
    monkeypatch.setattr(FakeCapture, "opened", [])
    monkeypatch.setattr(cv2, "VideoCapture", FakeCapture)
    reg = tmp_path / "register_cam.py"
    reg.write_text(
        "import numpy as np\n"
        "from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta\n"
        f"register_meta(DatasetMeta(name='synthcam', id2obj={dict(meta.id2obj)!r}, "
        f"width={meta.width}, height={meta.height}, "
        f"camera_matrix=np.array({np.asarray(meta.camera_matrix).tolist()!r})))\n")
    dets = demo_yolox.main(["--dataset", "synthcam", "--register", str(reg),
                            "--images", "3", "--max-frames", "2", "--size", "yolox_s",
                            "--input-size", "64", "--conf-thr", "0.0",
                            "--out", str(tmp_path / "det"), "--allow-random-weights",
                            "--device", "cpu"])
    assert FakeCapture.opened == [3]
    assert sorted(dets) == ["cam_000000", "cam_000001"]
    assert (tmp_path / "det" / "cam_000001_det.png").exists()
    all3 = demo_yolox.main(["--dataset", "synthcam", "--images", "0", "--size", "yolox_s",
                            "--input-size", "64", "--out", str(tmp_path / "det3"),
                            "--allow-random-weights", "--device", "cpu"])
    assert sorted(all3) == ["cam_000000", "cam_000001", "cam_000002"]
