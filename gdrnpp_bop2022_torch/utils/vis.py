"""Drawing on the host: the trainer's batch tiles and the demos' boxes.

The port's copy of ``gdrnpp_bop2022_tpu/utils/vis.py``'s ``grid_show``
(reference lib/vis_utils grid_show; written to a file, not a window),
``bbox3d_corners``, ``project_pts`` and ``draw_pose_bbox`` (the GDRN demo's
projected 3D boxes), ``overlay_mask`` (``tools/vis_dataset.py``'s mask
panels), and ``draw_detections``, the detector demo's 2D boxes
(``tools/demo_yolox.py``'s drawing).
"""

from __future__ import annotations

import numpy as np

_BOX_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
              (0, 4), (1, 5), (2, 6), (3, 7)]


def bbox3d_corners(extent: np.ndarray, center: np.ndarray | None = None) -> np.ndarray:
    """8 corners (8, 3) of an axis-aligned box with the given extent."""
    ex, ey, ez = np.asarray(extent) * 0.5
    corners = np.array([
        [-ex, -ey, -ez], [ex, -ey, -ez], [ex, ey, -ez], [-ex, ey, -ez],
        [-ex, -ey, ez], [ex, -ey, ez], [ex, ey, ez], [-ex, ey, ez],
    ])
    return corners if center is None else corners + np.asarray(center)


def project_pts(pts: np.ndarray, K: np.ndarray, R: np.ndarray, t: np.ndarray):
    pc = pts @ R.T + t.reshape(1, 3)
    uvw = pc @ K.T
    return uvw[:, :2] / np.maximum(uvw[:, 2:], 1e-12)


def draw_pose_bbox(img: np.ndarray, K: np.ndarray, R: np.ndarray, t: np.ndarray,
                   extent: np.ndarray, color=(0, 255, 0), thickness=2,
                   center: np.ndarray | None = None) -> np.ndarray:
    """A copy of img with the projected 3D bounding box of a posed object."""
    import cv2
    out = img.copy()
    uv = project_pts(bbox3d_corners(extent, center), K, R, t)
    # near-zero depths from random weights project far away: clip into
    # what cv2's int coordinates hold
    uv = np.clip(np.nan_to_num(uv), -10_000, 10_000).astype(np.int32)
    for a, b in _BOX_EDGES:
        cv2.line(out, (int(uv[a, 0]), int(uv[a, 1])), (int(uv[b, 0]), int(uv[b, 1])),
                 color, thickness)
    return out


def draw_detections(img: np.ndarray, boxes, names, scores,
                    color=(0, 255, 0)) -> np.ndarray:
    """A copy of img with each xyxy box and its "name score" caption."""
    import cv2
    out = np.ascontiguousarray(img).copy()
    for b, name, sc in zip(boxes, names, scores):
        x1, y1, x2, y2 = (int(v) for v in np.clip(np.nan_to_num(b), -10_000, 10_000))
        cv2.rectangle(out, (x1, y1), (x2, y2), color, 2)
        cv2.putText(out, f"{name} {float(sc):.2f}", (x1, y1 - 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return out


def overlay_mask(img: np.ndarray, mask: np.ndarray,
                 color=(255, 0, 0), alpha=0.4) -> np.ndarray:
    """img with ``color`` blended in at ``alpha`` where mask is set."""
    out = img.astype(np.float32).copy()
    m = mask.astype(bool)
    out[m] = out[m] * (1 - alpha) + np.asarray(color, np.float32) * alpha
    return out.astype(np.uint8)


def grid_show(images, titles=None, out_path=None, cols=4):
    """Tile (H, W[, 3]) images into one uint8 RGB canvas; float images are
    min-max scaled. Writes out_path (PNG) when given."""
    import cv2
    n = len(images)
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    canvas = np.zeros((rows * h, cols * w, 3), np.uint8)
    for i, im in enumerate(images):
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        if im.dtype != np.uint8:
            lo, hi = float(im.min()), float(im.max())
            im = ((im - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
        r, c = divmod(i, cols)
        canvas[r * h:r * h + im.shape[0], c * w:c * w + im.shape[1]] = im[..., :3]
        if titles:
            cv2.putText(canvas, str(titles[i]), (c * w + 4, r * h + 16),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, (255, 255, 0), 1)
    if out_path:
        cv2.imwrite(out_path, canvas[..., ::-1])
    return canvas
