"""batch_p95_ms: the 95th percentile (numpy's linear interpolation) over every
batch of the window of the time from the serving loop's taking the batch to
its next request (host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.feed.lat, 95) * 1e3)
