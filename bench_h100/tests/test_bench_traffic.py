"""The traffic: the mix's multiset of frame sizes, the packing, the host batches."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100 import traffic
from bench_h100.scene import make_frames, mesh_bank

BENCH = Path(__file__).resolve().parent.parent
MIX = json.loads((BENCH / "traffic" / "serve_multi.json").read_text())
SCENE = {"width": 80, "height": 60, "K": [[133.4, 0.0, 39.1], [0.0, 133.5, 30.2], [0.0, 0.0, 1.0]],
         "z_m": [1.0, 1.5], "margin_px": 10, "box_jitter_px": 1.0, "score": [0.3, 1.0]}


def test_serve_multi_is_ycbv_test_density():
    counts = traffic.frame_counts(MIX)
    assert len(counts) == 48 and sum(counts) == 240          # 5 a frame, as 4123 / 900
    assert min(counts) == 3 and max(counts) == 7


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11, 987654321987])
def test_every_seed_packs_the_same_work(seed):
    counts = traffic.frame_order(MIX, np.random.default_rng(seed))
    assert sorted(counts) == sorted(traffic.frame_counts(MIX))
    packed = traffic.pack(counts, MIX["batch_size"], MIX["images_per_batch"])
    assert len(packed) == MIX["batches"]
    rois = [sum(counts[f] for f in b) for b in packed]
    assert sum(rois) == 240 and max(rois) <= 64
    assert all(len(b) <= 16 for b in packed)
    assert [f for b in packed for f in b] == list(range(48))    # frames in order, none split


def test_pack_flushes_as_the_loader_does():
    # 60 ROIs, then a frame of 5 does not fit: flush; a 17th image never fits 16 slots
    assert traffic.pack([6] * 10 + [5], 64, 16) == [list(range(10)), [10]]
    assert traffic.pack([1] * 17, 64, 16) == [list(range(16)), [16]]
    with pytest.raises(ValueError):
        traffic.pack([65], 64, 16)


def _frames(counts, seed=3):
    axes = np.random.default_rng(seed).uniform(0.02, 0.05, (21, 3))
    gen = torch.Generator().manual_seed(seed)
    return make_frames(gen, counts, SCENE, axes, "cpu")


def test_host_batches_equal_the_program_loader():
    """The benchmark's packing against the program's own loader on the same
    frames, held in memory."""
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    counts = [3, 7, 5, 4, 6, 5, 3, 7]
    images, depths, dets = _frames(counts)
    mine = [traffic.host_batch(fr, images, depths, dets, SCENE["K"], 16, 4)
            for fr in traffic.pack(counts, 16, 4)]
    index = {f"{traffic.SCENE_ID}/{f}": {"image": images[f], "K": np.asarray(SCENE["K"]),
                                          "scene_id": traffic.SCENE_ID, "im_id": f}
             for f in range(len(counts))}
    det_in = {f"{traffic.SCENE_ID}/{f}": dets[f] for f in range(len(counts))}
    theirs = list(iter_test_batches(index, det_in, batch_size=16, images_per_batch=4))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for k in ("images", "img_idx", "boxes_xyxy", "Ks", "labels", "scores", "valid"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert [tuple(m) for m in a["metas"]] == [
            (m.scene_id, m.im_id, m.obj_id, m.score, m.det_time) for m in b["metas"]]
        # depth slots hold the frames the image slots hold
        for slot, f in {int(i): m.im_id for i, m in zip(a["img_idx"], a["metas"])}.items():
            np.testing.assert_array_equal(a["depths"][slot], depths[f])


def test_frames_are_the_seeds_and_in_view():
    counts = [3, 5, 4]
    a, b = _frames(counts, 9), _frames(counts, 9)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for frame_dets, n in zip(a[2], counts):
        assert len(frame_dets) == n and len({d["label"] for d in frame_dets}) == n
        for d in frame_dets:
            x1, y1, x2, y2 = d["bbox_xyxy"]
            assert x2 > x1 and y2 > y1
    assert (a[1] > 0).any() and a[0].dtype == np.uint8


def test_mesh_bank_shapes():
    verts, faces = mesh_bank(np.full((2, 3), 0.05), 33, 64)
    assert verts.shape == (2, 2 + 32 * 64, 3) and faces.shape == (2, 4096, 3)
    assert np.abs(np.linalg.norm(verts[0], axis=1) - 0.05).max() < 1e-6
