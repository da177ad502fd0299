"""Port parity: ROI crop-resize and the test-batch builder against JAX.

The JAX serving path crops with its matmul form (``roi_crop_resize_mxu``
via ``compute_test_rois``); the port crops with a gather. Both are the
same bilinear resample with cv2 pixel centres and a zero border, so the
port is compared with ``build_test_batch`` itself. Boxes run off every
edge of the image so the border handling is exercised.

Tolerances: crops of uint8 images normalised to [0, 1] at 1e-5 (fp32
sums of four taps, in another order); geometry outputs at 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.engine.batching import build_test_batch as j_build
from gdrnpp_bop2022_tpu.ops.crop import roi_crop_resize as j_crop
from gdrnpp_bop2022_torch.engine.batching import build_test_batch
from gdrnpp_bop2022_torch.ops.crop import affine_grid_from_boxes, roi_crop_resize


def _scene(seed=0, M=3, H=48, W=64, B=7):
    rs = np.random.RandomState(seed)
    images = rs.randint(0, 256, (M, H, W, 3)).astype(np.uint8)
    x1 = rs.uniform(-20, W - 5, B)
    y1 = rs.uniform(-20, H - 5, B)
    boxes = np.stack([x1, y1, x1 + rs.uniform(4, 50, B), y1 + rs.uniform(4, 40, B)],
                     -1).astype(np.float32)
    boxes[0] = [-30, -30, W + 30, H + 30]        # larger than the image: clipped
    K = np.array([[60.0, 0, 32], [0, 60, 24], [0, 0, 1]], np.float32)
    return {
        "images": images,
        "img_idx": rs.randint(0, M, B).astype(np.int32),
        "boxes": boxes,
        "Ks": np.tile(K, (B, 1, 1)),
        "labels": rs.randint(0, 4, B).astype(np.int32),
        "extents": rs.uniform(0.05, 0.2, (4, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("coord_2d_type", ["abs", "rel"])
def test_build_test_batch_matches_jax(coord_2d_type):
    s = _scene()
    kw = dict(input_res=32, output_res=8, pixel_mean=(10.0, 20.0, 30.0),
              pixel_std=(255.0, 200.0, 128.0), coord_2d_type=coord_2d_type)
    want = j_build(jnp.asarray(s["images"]), jnp.asarray(s["img_idx"]),
                   jnp.asarray(s["boxes"]), jnp.asarray(s["Ks"]),
                   jnp.asarray(s["labels"]), jnp.asarray(s["extents"]), **kw)
    t = {k: torch.from_numpy(v) for k, v in s.items()}
    got = build_test_batch(t["images"], t["img_idx"], t["boxes"], t["Ks"],
                           t["labels"], t["extents"], **kw)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape, k
        if k == "roi_img":
            np.testing.assert_allclose(g, w, atol=1e-5 * 255 / 128, err_msg=k)
        elif k == "roi_labels":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
    # the zero border reached the crop of the oversized box
    assert (got["roi_img"][0, 0, 0] == -torch.tensor([10.0, 20.0, 30.0])
            / torch.tensor([255.0, 200.0, 128.0])).all()


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_roi_crop_resize_matches_jax_gather(method):
    s = _scene(seed=1)
    idx = s["img_idx"]
    per_roi = s["images"][idx].astype(np.float32)
    rs = np.random.RandomState(2)
    centers = rs.uniform(-5, 70, (len(idx), 2)).astype(np.float32)
    scales = rs.uniform(5, 60, len(idx)).astype(np.float32)
    want = np.asarray(j_crop(jnp.asarray(per_roi), jnp.asarray(centers),
                             jnp.asarray(scales), 12, method=method))
    # one image per ROI, and the indexed stack the serving path uses
    got_a = roi_crop_resize(torch.from_numpy(per_roi), torch.from_numpy(centers),
                            torch.from_numpy(scales), 12, method=method)
    got_b = roi_crop_resize(torch.from_numpy(s["images"]), torch.from_numpy(centers),
                            torch.from_numpy(scales), 12, method=method,
                            img_idx=torch.from_numpy(idx))
    np.testing.assert_allclose(got_a.numpy(), want, atol=1e-4)
    torch.testing.assert_close(got_a, got_b, rtol=0, atol=0)


def test_affine_grid_centre_and_span():
    g = affine_grid_from_boxes(torch.tensor([[10.0, 20.0]]), torch.tensor([8.0]), 4)
    assert g.shape == (1, 4, 4, 2)
    assert g[0, 0, 0].tolist() == [6.0, 16.0]      # centre - scale / 2
    assert g[0, 2, 2].tolist() == [10.0, 20.0]     # out/2 maps to the centre
