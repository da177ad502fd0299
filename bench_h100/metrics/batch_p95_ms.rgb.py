"""batch_p95_ms.rgb: ``batch_p95_ms`` as a per-layer metric, for the cells whose
batch tail swings too far between runs to be held end to end (the RGB cell: its
launch-bound forward stretches in the host's slow episodes). The 95th
percentile (numpy's linear interpolation) over every batch of the window of the
time from the serving loop's taking the batch to its next request (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.feed.lat, 95) * 1e3) if run.feed.lat else None
