"""serve_rois_per_s: valid ROIs whose poses reached the host in the window,
over the window's seconds on the host clock."""


def read(run):
    return run.window_rois / run.window_s
