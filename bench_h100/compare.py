"""What decides ``correct``: every served row against the reference's pose for its ROI.

The serving loop returns one row per valid ROI of each batch it took, in
order. Each row is matched to its ROI slot through the order in which the
benchmark handed out the pool's batches, and its (scene, image, object) must
be that slot's. The readings: rows that are missing, extra or misplaced
(exact, limit 0); and per row the rotation gap (degrees, the geodesic
angle between the served R and the reference's), the translation gap
(|t - t_ref| over |t_ref|) and the corner gap (mm, the largest displacement
of the object's extent-box corners), each read over the rows as the widest
and at the 50th, 90th and 99th percentiles, and as the share of rows whose
gap is over each threshold that the configuration's file lists under
``correct.shares`` (``rot_gap_deg_share_over_0.4``). The file names the
readings it compares and their limits; ``calibrate.py`` records them all. A
row whose pose is not finite reads an infinite gap.
"""

from __future__ import annotations

import numpy as np


def gaps(R, t, R_ref, t_ref):
    """Per row: the rotation gap in degrees and the relative translation gap."""
    # |R - R_ref|_F = 2 sqrt(2) sin(angle / 2): exact near 0, where arccos of the trace is not
    chord = np.linalg.norm((R.astype(np.float64) - R_ref).reshape(len(R), 9), axis=-1)
    rot = np.degrees(2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0)))
    tg = np.linalg.norm(t - t_ref, axis=-1) / np.linalg.norm(t_ref, axis=-1)
    bad = ~(np.isfinite(R).all(axis=(1, 2)) & np.isfinite(t).all(axis=-1))
    return np.where(bad, np.inf, rot), np.where(bad, np.inf, tg)


def corner_gap_mm(R, t, R_ref, t_ref, extents):
    """Per row: the largest displacement (mm) of the 8 corners of the object's
    extent box between the served pose and the reference's."""
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
    corners = 0.5 * extents[:, None, :] * signs                     # (n, 8, 3)
    d = (np.einsum("nij,nkj->nki", R - R_ref, corners) + (t - t_ref)[:, None, :])
    g = np.linalg.norm(d, axis=-1).max(axis=1) * 1e3
    return np.where(np.isfinite(g), g, np.inf)


def per_row(results, order, pool, reference, extents) -> dict:
    """results: the serving loop's rows; order: the pool index of every batch
    it was handed, in order; reference[b] = (R (n, 3, 3), t (n, 3)) of pool
    batch b's valid slots; extents (C, 3) of the classes, meters. -> the
    counts of rows missing, extra and misplaced, and each row's gaps."""
    want = [(b, i) for b in order for i in range(int(pool[b]["valid"].sum()))]
    n = min(len(want), len(results))
    misplaced = 0
    R = np.full((n, 3, 3), np.nan)
    t = np.full((n, 3), np.nan)
    R_ref, t_ref = np.zeros((n, 3, 3)), np.ones((n, 3))
    ext = np.zeros((n, 3))
    for k in range(n):
        b, i = want[k]
        row, meta = results[k], pool[b]["metas"][i]
        if (row["scene_id"], row["im_id"], row["obj_id"]) != (meta.scene_id, meta.im_id,
                                                               meta.obj_id):
            misplaced += 1
            continue
        R[k], t[k] = row["R"], row["t"]
        R_ref[k], t_ref[k] = reference[b][0][i], reference[b][1][i]
        ext[k] = extents[pool[b]["labels"][i]]
    rot, tg = gaps(R, t, R_ref, t_ref)
    return {"rows_missing": len(want) - n, "rows_extra": len(results) - n,
            "rows_misplaced": misplaced, "rows": n, "rot_gap_deg": rot, "t_gap_rel": tg,
            "corner_gap_mm": corner_gap_mm(R, t, R_ref, t_ref, ext)}


GAPS = ("rot_gap_deg", "t_gap_rel", "corner_gap_mm")
QUANTILES = (50, 90, 99)


def readings(rows: dict, shares: dict = None) -> dict:
    """The counts, and each gap's widest, percentiles and shares over
    thresholds (``shares``: gap name -> thresholds) over the rows."""
    out = {k: v for k, v in rows.items() if k not in GAPS}
    for name in GAPS:
        v = rows[name] if len(rows[name]) else np.zeros(1)
        out[name] = float(v.max())
        for q in QUANTILES:
            out[f"{name}_p{q}"] = float(np.percentile(v, q))
        for over in (shares or {}).get(name, ()):
            out[f"{name}_share_over_{over}"] = float((v > over).mean())
    return out


def judge(read: dict, limits: dict):
    """(correct, [(name, value, limit)]) for every number compared."""
    rows = [(k, read[k], 0) for k in ("rows_missing", "rows_extra", "rows_misplaced")]
    rows += [(k, read[k], lim) for k, lim in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows
