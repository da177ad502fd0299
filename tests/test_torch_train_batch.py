"""Port parity: the online training batch against the JAX package.

``build_train_batch_online`` (ROI crops, the depth + XYZ render at the
crop-K through the rasterizer's plain version here, masks, region labels,
SITE targets) is held against the JAX builder (whose CPU render is the XLA
scan) for xyz_bp True and False and xyz_bin 0 and 64, on two cube meshes
posed in front of a 120x160 camera, with boxes and DZI-jittered crops from
``dzi_jitter_host``.

Tolerances: masks and silhouettes equal; gt_xyz within 1e-4 where the
object is (XLA's and the plain scan's tie pixels, where two faces meet at
the same depth, may take either face: at most 0.5% of the hit pixels);
region labels equal except where the two nearest keypoints are within 1e-5
relative; binned xyz equal except within 1e-4 of a bin edge; SITE targets
and coord-2d at 1e-5; crops at the ROI-batch test's 1e-5 of [0, 1].
``dzi_jitter_host`` is bit-equal from the same RandomState for all four
types; ``trunc_mask_batch`` equals the JAX device version and its host
twin, and ``xyz_to_region`` matches on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.engine import batching as jb
from gdrnpp_bop2022_tpu.ops.region import xyz_to_region as j_region
from gdrnpp_bop2022_torch.engine.batching import (build_train_batch_online,
                                                  dzi_jitter_host, trunc_mask_batch)
from gdrnpp_bop2022_torch.ops.region import xyz_to_region

H, W = 120, 160
K = np.array([[120.0, 0, 80.0], [0, 120.0, 60.0], [0, 0, 1]], np.float32)


def _cube(half):
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float32) * half
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
                  [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return v, f


def _rot(rs):
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return (q * np.sign(np.linalg.det(q))).astype(np.float32)


def _inputs(seed=0, B=5, M=3, R=8):
    rs = np.random.RandomState(seed)
    cubes = [_cube(0.03), _cube(0.02)]
    verts = np.stack([c[0] for c in cubes])
    faces = np.stack([c[1] for c in cubes])
    fps = np.stack([rs.uniform(-h, h, (R, 3)) for h in (0.03, 0.02)]).astype(np.float32)
    extents = np.array([[0.06] * 3, [0.04] * 3], np.float32)
    labels = rs.randint(0, 2, B).astype(np.int32)
    rots = np.stack([_rot(rs) for _ in range(B)])
    t = np.stack([rs.uniform(-0.08, 0.08, B), rs.uniform(-0.05, 0.05, B),
                  rs.uniform(0.4, 0.7, B)], -1).astype(np.float32)
    uv = (K @ (t / t[:, 2:]).T).T[:, :2]
    half = 120.0 * 0.05 / t[:, 2]
    boxes = np.concatenate([uv - half[:, None], uv + half[:, None]], -1).astype(np.float32)
    centers, scales = dzi_jitter_host(np.random.RandomState(seed + 1), boxes, W, H)
    return {
        "images": rs.randint(0, 256, (M, H, W, 3)).astype(np.uint8),
        "img_idx": rs.randint(0, M, B).astype(np.int32),
        "centers": centers, "scales": scales, "bboxes_xyxy": boxes,
        "Ks": np.tile(K, (B, 1, 1)), "labels": labels, "gt_rots": rots, "gt_transes": t,
        "mask_visib": (rs.rand(M, H, W) > 0.3).astype(np.float32),
        "mask_full": (rs.rand(B, H, W) > 0.2).astype(np.float32),
        "mask_idx": rs.randint(0, M, B).astype(np.int32),
        "verts": verts, "faces": faces, "fps_points": fps, "extents": extents,
        "mask_full_idx": np.arange(B, dtype=np.int32),
    }


def _near_tie(xyz, kp, labels, rel=1e-5):
    """Pixels whose two nearest keypoints are within `rel` (float64)."""
    d = ((xyz.astype(np.float64)[..., None, :] - kp[:, None, None].astype(np.float64)) ** 2).sum(-1)
    s = np.sort(d, axis=-1)
    return (s[..., 1] - s[..., 0]) <= rel * np.maximum(s[..., 1], 1e-12)


@pytest.mark.parametrize("xyz_bp", [True, False])
@pytest.mark.parametrize("xyz_bin", [0, 64])
def test_train_batch_matches_jax(xyz_bp, xyz_bin):
    s = _inputs()
    kw = dict(input_res=64, output_res=32, pixel_mean=(10.0, 20.0, 30.0),
              pixel_std=(255.0, 200.0, 128.0), xyz_bin=xyz_bin, coord_2d_type="abs",
              xyz_bp=xyz_bp)
    order = ("images", "img_idx", "centers", "scales", "bboxes_xyxy", "Ks", "labels",
             "gt_rots", "gt_transes", "mask_visib", "mask_full", "mask_idx", "verts",
             "faces", "fps_points", "extents")
    want = jb.build_train_batch_online(*(jnp.asarray(s[k]) for k in order),
                                       mask_full_idx=jnp.asarray(s["mask_full_idx"]),
                                       num_regions=8, **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    got = build_train_batch_online(*(t[k] for k in order), mask_full_idx=t["mask_full_idx"],
                                   **kw)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
    obj = want["gt_mask_obj"] > 0.5
    assert obj.sum() > 200
    for k in ("gt_mask_obj", "gt_mask_visib", "gt_mask_full", "gt_mask_trunc", "roi_labels"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["roi_img"], want["roi_img"], atol=1e-5 * 255 / 128)
    for k in ("roi_coord_2d", "roi_cams", "roi_centers", "roi_whs", "roi_extents",
              "resize_ratios", "gt_trans_ratio", "gt_rot", "gt_trans"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)
    bad = (np.abs(got["gt_xyz"] - want["gt_xyz"]) > 1e-4).any(-1) & obj
    assert bad.sum() <= 0.005 * obj.sum(), bad.sum()
    assert (got["gt_xyz"][~obj] == 0).all()
    # region labels, away from near-ties of the JAX package's own xyz
    xyz = (want["gt_xyz"] - 0.5) * want["roi_extents"][:, None, None, :] * obj[..., None]
    kp = s["fps_points"][s["labels"]]
    tie = _near_tie(xyz, kp, want["gt_region"]) | bad
    np.testing.assert_array_equal(got["gt_region"][~tie], want["gt_region"][~tie])
    assert (got["gt_region"][~obj] == 0).all() and got["gt_region"].max() <= 8
    if xyz_bin:
        edge = np.abs(want["gt_xyz"] * xyz_bin - np.round(want["gt_xyz"] * xyz_bin)) < 1e-4
        ok = ~(edge | bad[..., None])
        np.testing.assert_array_equal(got["gt_xyz_bin"][ok], want["gt_xyz_bin"][ok])
        assert (got["gt_xyz_bin"][~obj] == xyz_bin).all()


@pytest.mark.parametrize("dzi_type", ["uniform", "truncnorm", "roi10d", "none"])
def test_dzi_jitter_bit_equal(dzi_type):
    rs = np.random.RandomState(3)
    boxes = np.stack([rs.uniform(-10, 500, 40), rs.uniform(-10, 400, 40)], -1)
    boxes = np.concatenate([boxes, boxes + rs.uniform(5, 200, (40, 2))], -1).astype(np.float32)
    kw = dict(pad_scale=1.5, scale_ratio=0.25, shift_ratio=0.25, dzi_type=dzi_type)
    c1, s1 = jb.dzi_jitter_host(np.random.RandomState(9), boxes, 640, 480, **kw)
    c2, s2 = dzi_jitter_host(np.random.RandomState(9), boxes, 640, 480, **kw)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(s1, s2)
    assert c2.dtype == s2.dtype == np.float32


def test_trunc_mask_batch_matches_jax_and_host():
    from gdrnpp_bop2022_tpu.datasets.train_loader import GdrnTrainLoader as JLoader
    rs = np.random.RandomState(5)
    masks = np.zeros((12, 30, 40), np.float32)
    for i in range(11):                                  # the last mask stays empty
        y0, x0 = rs.randint(0, 20), rs.randint(0, 30)
        masks[i, y0:y0 + rs.randint(2, 10), x0:x0 + rs.randint(2, 10)] = 1.0
    draws = rs.uniform(size=(12, 2)).astype(np.float32)
    draws[:5, 0] = [0.1, 0.3, 0.5, 0.7, 0.9]             # every branch
    got = trunc_mask_batch(torch.from_numpy(masks), torch.from_numpy(draws)).numpy()
    want = np.asarray(jb.trunc_mask_batch(jnp.asarray(masks), jnp.asarray(draws)))
    np.testing.assert_array_equal(got, want)
    host = np.stack([JLoader._trunc_mask(None, m, d) for m, d in zip(masks, draws)])
    np.testing.assert_array_equal(got, host)
    assert got.dtype == np.float32 and (got <= masks).all()


def test_xyz_to_region_matches_jax():
    rs = np.random.RandomState(6)
    xyz = rs.uniform(-0.05, 0.05, (3, 9, 11, 3)).astype(np.float32)
    xyz[:, :2] = 0.0                                      # background rows
    fps = rs.uniform(-0.05, 0.05, (3, 16, 3)).astype(np.float32)
    want = np.asarray(j_region(jnp.asarray(xyz), jnp.asarray(fps)))
    got = xyz_to_region(torch.from_numpy(xyz), torch.from_numpy(fps)).numpy()
    tie = _near_tie(xyz, fps, want)
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert (got[:, :2] == 0).all() and got.min() >= 0 and got.max() <= 16
    mask = rs.rand(3, 9, 11) > 0.5
    got_m = xyz_to_region(torch.from_numpy(xyz), torch.from_numpy(fps),
                          mask=torch.from_numpy(mask)).numpy()
    assert (got_m[~mask] == 0).all()
    fg = mask & ~tie & (xyz != 0).any(-1)
    np.testing.assert_array_equal(got_m[fg], got[fg])
