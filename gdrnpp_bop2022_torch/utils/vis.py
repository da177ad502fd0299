"""Image tiling for the trainer's batch dumps.

The port's copy of ``grid_show`` from ``gdrnpp_bop2022_tpu/utils/vis.py``
(reference lib/vis_utils grid_show; written to a file, not a window).
"""

from __future__ import annotations

import numpy as np


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
