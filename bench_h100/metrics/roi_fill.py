"""roi_fill: valid ROIs over the ROI rows the window's forwards were given
(``roi_img.shape[0]``, counted by the harness's forward pre-hook)."""


def read(run):
    rows = run.rows.get("window", 0)
    return run.window_rois / rows if rows else None
