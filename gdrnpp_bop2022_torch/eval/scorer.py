"""BOP19 scoring: greedy est->gt matching and recall averaging.

Port of ``gdrnpp_bop2022_tpu/eval/scorer.py``: the in-process counterpart
of the reference's eval_calc_errors + eval_calc_scores subprocesses
(lib/pysixd/scripts/eval_pose_results_more.py, driven by
core/gdrn_modeling/engine/test_utils.py:33-80). Error grids follow
eval_pose_results_more.py:41-83:

  vsd : tau in 0.05:0.05:0.5 (of the diameter), th in 0.05:0.05:0.5,
        delta = 15 mm (5 mm for itodd)
  mssd: th in 0.05:0.05:0.5 of the object diameter
  mspd: th in 5:5:50 scaled by r = image_width / 640
  AR = mean(AR_vsd, AR_mssd, AR_mspd)

plus the custom ad/adi/re/te/proj recalls (gdrn_custom_evaluator.py:622-760)
and the precision tables. Matching follows the BOP toolkit exactly
(lib/pysixd/pose_matching.py:9-91): it is re-run per correctness threshold,
each score-sorted estimate taking the unmatched GT of lowest error under it.

Phases: (1) on the host, per-target jobs and the flattened (est, gt) pose
pairs of every target; (2) on ``device``, one chunked pass per error type
and per VSD render mode, per-pair model data gathered from banks held on
the device, a few chunks in flight; (3) on the host, the greedy matchings
(``reduceat`` minima where a target has one estimate or one GT); (4) on the
device, the aux errors of the matched pairs.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops.rasterizer import render_depth_xyz
from .pose_error import (add_batch, adi_batch, mspd_batch, mssd_batch, proj_batch,
                         re_batch, te_batch)
from .vsd import vsd_batch, vsd_batch_bbox, vsd_batch_full, vsd_bbox_plan, window_fits

MSSD_THS = np.arange(0.05, 0.51, 0.05)
MSPD_THS = np.arange(5, 51, 5)
VSD_TAUS = np.arange(0.05, 0.51, 0.05)
VSD_THS = np.arange(0.05, 0.51, 0.05)

_PAIR_CHUNK = 2048       # pose pairs per device pass (the cheap error types)
_VSD_WIN_CHUNK = 256     # pairs per windowed-VSD pass at 128^2; the image-grid
                         # buckets take 256 * 128^2 / (bh * bw) pairs, so each
                         # pass renders about the same number of pixels
_VSD_FULL_CHUNK = 16     # pairs per full-image VSD pass: the (10, 16, 480,
                         # 640) bool cost cube is 49 MB
_MAX_INFLIGHT = 4        # chunks enqueued before the oldest is copied back


def _group(results):
    g = defaultdict(list)
    for r in results:
        g[(r["scene_id"], r["im_id"], r["obj_id"])].append(r)
    return g


def _sym_banks(model_bank):
    """Padded per-class symmetry banks (C, Smax, ...) and validity mask.
    BOP symmetries carry translations for off-centre symmetry axes
    (lib/pysixd/misc.py get_symmetry_transformations)."""
    C = len(model_bank.obj_ids)
    s_max = 1
    for s in model_bank.sym_rotations:
        if s is not None:
            s_max = max(s_max, len(s))
    symR = np.tile(np.eye(3, dtype=np.float32), (C, s_max, 1, 1))
    symT = np.zeros((C, s_max, 3), np.float32)
    symV = np.zeros((C, s_max), bool)
    symV[:, 0] = True
    sym_t_bank = getattr(model_bank, "sym_translations", None)
    for c in range(C):
        s = model_bank.sym_rotations[c]
        if s is None:
            continue
        n = len(s)
        symR[c, :n] = np.asarray(s, np.float32)
        symV[c, :n] = True
        if sym_t_bank is not None and sym_t_bank[c] is not None:
            symT[c, :n] = np.asarray(sym_t_bank[c], np.float32)
    return symR, symT, symV


# --- the pair programs: banks live on the device, pairs gather from them ----

def _mssd_pairs(Re, te, Rg, tg, label, pts_bank, symR_b, symT_b, symV_b):
    return mssd_batch(Re, te, Rg, tg, pts_bank[label], symR_b[label], symT_b[label],
                      symV_b[label])


def _mspd_pairs(Re, te, Rg, tg, K, label, pts_bank, symR_b, symT_b, symV_b):
    return mspd_batch(Re, te, Rg, tg, K, pts_bank[label], symR_b[label], symT_b[label],
                      symV_b[label])


def _add_pairs(Re, te, Rg, tg, label, pts_bank):
    return add_batch(Re, te, Rg, tg, pts_bank[label])


def _aux_pairs(Re, te, Rg, tg, K, label, pts_bank, symR_b, symV_b):
    """(5, n): add, adi, re to the symmetry-closest GT rotation, te, and
    proj at that rotation (reference custom evaluator: get_closest_rot over
    the discrete symmetries of SYM_OBJS, gdrn_custom_evaluator.py:687-723;
    rotation only). A class without symmetries has only the identity valid,
    so it gets plain re/proj."""
    P = pts_bank[label]
    Rg_s = Rg[:, None] @ symR_b[label]                        # (n, S, 3, 3)
    S = Rg_s.shape[1]
    res = re_batch(Re[:, None].expand(-1, S, -1, -1), Rg_s)   # (n, S)
    res = torch.where(symV_b[label], res, torch.full_like(res, float("inf")))
    best_re, k = res.min(dim=1)
    Rg_best = Rg_s[torch.arange(len(k), device=k.device), k]
    return torch.stack([add_batch(Re, te, Rg, tg, P), adi_batch(Re, te, Rg, tg, P), best_re,
                        te_batch(te, tg), proj_batch(Re, te, Rg_best, tg, K, P)])


def _vsd_win_pairs(Re, te, Rg, tg, depth, K, label, diam, verts_bank, faces_bank, taus,
                   delta, render):
    return vsd_batch(Re, te, Rg, tg, depth, K, verts_bank[label], faces_bank[label], diam,
                     taus, delta, render=render)


def _vsd_full_pairs(Re, te, Rg, tg, depth, K, label, diam, verts_bank, faces_bank, taus,
                    delta, render):
    return vsd_batch_full(Re, te, Rg, tg, depth, K, verts_bank[label], faces_bank[label],
                          diam, taus, delta, render=render)


def _vsd_bbox_pairs(Re, te, Rg, tg, depth, offs, K, label, diam, verts_bank, faces_bank,
                    taus, delta, render):
    return vsd_batch_bbox(Re, te, Rg, tg, depth, offs, K, verts_bank[label],
                          faces_bank[label], diam, taus, delta, render=render)


def _run_chunked(fn, arrays: Dict[str, np.ndarray], n: int, chunk: int, device,
                 pair_axis: int = 0, gather=None):
    """``fn(**arrays)`` over chunks of the pair axis on ``device``; returns
    the numpy concatenation. pair_axis: the OUTPUT axis that carries the
    pairs (0 for (c, ...) outputs, -1 for aux's (5, c)).

    gather: {name: callable(i0, i1) -> device tensor} entries made per chunk
    (the per-pair depth images of VSD, from a bank of unique images), so
    memory is O(bank + chunk), not O(n). Up to _MAX_INFLIGHT chunks are
    enqueued before the oldest is copied back, so the host's work on chunk
    k+1 overlaps the device's on chunk k.
    """
    if n == 0:
        return None
    outs, pending = [], []
    for i0 in range(0, n, chunk):
        i1 = min(n, i0 + chunk)
        sl = {k: torch.as_tensor(v[i0:i1], device=device) for k, v in arrays.items()}
        for k, g in (gather or {}).items():
            sl[k] = g(i0, i1)
        pending.append(fn(**sl))
        if len(pending) >= _MAX_INFLIGHT:
            outs.append(pending.pop(0).cpu().numpy())
    outs += [p.cpu().numpy() for p in pending]
    return np.concatenate(outs, axis=pair_axis)


def score_bop_results(
    results: List[dict],          # est: scene_id, im_id, obj_id, score, R, t (m), K
    gts: List[dict],              # gt: scene_id, im_id, obj_id, R, t (m), visib_fract
    model_bank,                   # bop.models3d.ModelBank (eval models)
    targets: Optional[List[dict]] = None,   # BOP19 targets (scene/im/obj/inst_count)
    im_width: int = 640,
    depth_test_getter=None,       # callable (scene_id, im_id) -> (H, W) depth or None
    vsd_delta: float = 0.015,
    visib_gt_min: float = 0.1,
    n_top: int = -1,
    errors=("mssd", "mspd", "vsd"),
    vsd_mode: str = "full",       # full | auto | window (eval/vsd.py); full is
                                  # strict toolkit equivalence
    eval_precision: bool = True,  # also the DPOD-style prec_* tables
    sym_obj_labels=None,          # restrict the symmetry-closest re/proj aux
                                  # errors to these 0-based labels; None =
                                  # every object with a symmetry
    vsd_full_chunk: Optional[int] = None,   # pairs per full-image VSD pass
    device="cuda",
    render=render_depth_xyz,      # the depth renderer of VSD
    stats: Optional[dict] = None,  # out-param: pairs, VSD pairs per bucket,
                                   # seconds per phase, targets/s
) -> Dict[str, float]:
    """BOP AR scores and the aux recalls, on ``device`` (the card unless the
    caller passes the CPU). Returns a metrics dict."""
    if vsd_mode not in ("full", "auto", "window"):
        raise ValueError(f"vsd_mode={vsd_mode!r}: full | auto | window")
    device = torch.device(device)
    t_start = time.perf_counter()
    phase_s = defaultdict(float)
    label_of = {oid: i for i, oid in enumerate(model_bank.obj_ids)}
    est_g = _group(results)
    gt_g = _group([g for g in gts if g.get("visib_fract", 1.0) >= visib_gt_min])

    if targets is None:
        targets = [{"scene_id": s, "im_id": i, "obj_id": o, "inst_count": len(v)}
                   for (s, i, o), v in gt_g.items()]

    do_vsd = "vsd" in errors and depth_test_getter is not None
    r_mspd = im_width / 640.0

    # --- banks on the device ----------------------------------------------
    dev = lambda a: torch.as_tensor(a).to(device)             # noqa: E731
    pts_bank = dev(model_bank.points.astype(np.float32))
    symR_np, symT_np, symV_np = _sym_banks(model_bank)
    symR_b, symT_b, symV_b = dev(symR_np), dev(symT_np), dev(symV_np)
    sym_kw = dict(pts_bank=pts_bank, symR_b=symR_b, symT_b=symT_b, symV_b=symV_b)
    # the aux (custom-evaluator) errors honour DATASETS.SYM_OBJS: classes
    # outside it keep only the identity "symmetry" (gdrn_custom_evaluator.py:686-723)
    symV_aux = symV_b
    if sym_obj_labels is not None:
        member = np.zeros(symV_np.shape[0], bool)
        member[np.asarray(list(sym_obj_labels), int)] = True
        sv = symV_np & member[:, None]
        sv[:, 0] = True
        symV_aux = dev(sv)
    if do_vsd:
        vsd_kw = dict(verts_bank=dev(model_bank.verts.astype(np.float32)),
                      faces_bank=dev(np.asarray(model_bank.faces, np.int32)),
                      taus=dev(VSD_TAUS.astype(np.float32)), delta=float(vsd_delta),
                      render=render)
    # conservative per-class bounding-sphere radius for the bbox-VSD plan
    # (zero-padded verts never exceed the true max norm)
    radii_c = np.linalg.norm(np.asarray(model_bank.verts, np.float64), axis=-1).max(axis=1)

    # --- phase 1 (host): per-target jobs and flattened pose pairs ----------
    jobs = []
    pair_Re, pair_te, pair_Rg, pair_tg = [], [], [], []
    pair_K, pair_label, pair_diam = [], [], []
    depth_cache: Dict[tuple, Optional[np.ndarray]] = {}
    mssd_tp = np.zeros(len(MSSD_THS))
    mspd_tp = np.zeros(len(MSPD_THS))
    vsd_tp = np.zeros((len(VSD_TAUS), len(VSD_THS)))
    mssd_tar = mspd_tar = vsd_tar = 0
    err_rows = {e: [] for e in ("add", "adi", "re", "te", "proj")}
    n_pairs = 0
    vsd_buckets: Dict[str, int] = {}

    for tgt in targets:
        key = (int(tgt["scene_id"]), int(tgt["im_id"]), int(tgt["obj_id"]))
        n_inst = int(tgt.get("inst_count", 1))
        top = n_inst if n_top == -1 else n_top
        gt_list = gt_g.get(key, [])
        if not gt_list:
            continue
        n_gt = len(gt_list)
        label = label_of[key[2]]
        diam = float(model_bank.diameters[label])

        depth = None
        vsd_counted = False
        if do_vsd:
            im_key = (key[0], key[1])
            if im_key not in depth_cache:
                depth_cache[im_key] = depth_test_getter(*im_key)
            depth = depth_cache[im_key]
            # no depth: the target leaves VSD's accounting (counting it as
            # all-miss would depress AR_vsd)
            vsd_counted = depth is not None
        if "mssd" in errors:
            mssd_tar += n_gt
        if "mspd" in errors:
            mspd_tar += n_gt
        if vsd_counted:
            vsd_tar += n_gt

        ests = sorted(est_g.get(key, []), key=lambda r: -r["score"])[:top]
        if not ests:
            for k in err_rows:       # a pure miss: every GT unmatched
                err_rows[k].extend([(np.inf, diam)] * n_gt)
            continue

        ne = len(ests)
        Re = np.stack([np.asarray(e["R"], np.float32) for e in ests])
        te_ = np.stack([np.asarray(e["t"], np.float32).ravel() for e in ests])
        Rg = np.stack([np.asarray(g["R"], np.float32) for g in gt_list])
        tg = np.stack([np.asarray(g["t"], np.float32).ravel() for g in gt_list])
        K = np.stack([np.asarray(e.get("K", np.eye(3, dtype=np.float32)), np.float32)
                      for e in ests])
        jobs.append({"off": n_pairs, "ne": ne, "ng": n_gt, "diam": diam,
                     "depth": depth if vsd_counted else None, "key": key})
        pair_Re.append(np.repeat(Re, n_gt, axis=0))
        pair_te.append(np.repeat(te_, n_gt, axis=0))
        pair_Rg.append(np.tile(Rg, (ne, 1, 1)))
        pair_tg.append(np.tile(tg, (ne, 1)))
        pair_K.append(np.repeat(K, n_gt, axis=0))
        pair_label.append(np.full(ne * n_gt, label, np.int64))
        pair_diam.append(np.full(ne * n_gt, diam, np.float32))
        n_pairs += ne * n_gt
    phase_s["pairs"] += time.perf_counter() - t_start

    matched_pairs = []
    if n_pairs:
        P = {"Re": np.concatenate(pair_Re), "te": np.concatenate(pair_te),
             "Rg": np.concatenate(pair_Rg), "tg": np.concatenate(pair_tg)}
        P_K = np.concatenate(pair_K)
        P_label = np.concatenate(pair_label)
        P_diam = np.concatenate(pair_diam)

        # --- phase 2: the error tables, one chunked pass each ------------
        t0 = time.perf_counter()
        mssd_flat = (_run_chunked(lambda **a: _mssd_pairs(**a, **sym_kw),
                                  {**P, "label": P_label}, n_pairs, _PAIR_CHUNK, device)
                     if "mssd" in errors else None)
        mspd_flat = (_run_chunked(lambda **a: _mspd_pairs(**a, **sym_kw),
                                  {**P, "K": P_K, "label": P_label}, n_pairs, _PAIR_CHUNK,
                                  device)
                     if "mspd" in errors else None)
        add_flat = _run_chunked(lambda **a: _add_pairs(**a, pts_bank=pts_bank),
                                {**P, "label": P_label}, n_pairs, _PAIR_CHUNK, device)
        phase_s["errors"] += time.perf_counter() - t0

        # --- VSD: per-pair render mode (window, image-grid bucket, full) --
        t0 = time.perf_counter()
        vsd_flat = None
        vsd_rows = [j for j in jobs if j["depth"] is not None] if do_vsd else []
        if vsd_rows:
            vsd_flat = np.zeros((n_pairs, len(VSD_TAUS)), np.float32)
            # group by depth-image shape: mixed evaluation sets must not
            # inherit the first image's window geometry
            by_shape: Dict[tuple, list] = {}
            for j in vsd_rows:
                by_shape.setdefault(j["depth"].shape, []).append(j)
            for (im_h, im_w), rows in by_shape.items():
                idx = np.concatenate([np.arange(j["off"], j["off"] + j["ne"] * j["ng"])
                                      for j in rows])
                # one bank entry per UNIQUE depth image (targets of one image
                # share the cached array), on the device
                depth_of_pair = np.empty(len(idx), np.int64)
                depth_list, seen = [], {}
                pos = 0
                for j in rows:
                    n_j = j["ne"] * j["ng"]
                    di = seen.get(id(j["depth"]))
                    if di is None:
                        di = seen[id(j["depth"])] = len(depth_list)
                        depth_list.append(np.asarray(j["depth"], np.float32))
                    depth_of_pair[pos:pos + n_j] = di
                    pos += n_j
                depth_bank = dev(np.stack(depth_list))

                if vsd_mode == "window":
                    use_win = np.ones(len(idx), bool)
                elif vsd_mode == "full":
                    use_win = np.zeros(len(idx), bool)
                else:   # auto: the window only where it provably fits
                    use_win = window_fits(P["Re"][idx], P["te"][idx], P["Rg"][idx],
                                          P["tg"][idx], P_K[idx], P_diam[idx], im_h, im_w)
                full_chunk = vsd_full_chunk or _VSD_FULL_CHUNK

                def run_group(fn, pos, chunk, name, win=None, offs=None):
                    """pos: positions into this shape group's pair order."""
                    if not len(pos):
                        return
                    vsd_buckets[name] = vsd_buckets.get(name, 0) + len(pos)
                    sub = idx[pos]
                    arrs = {k: v[sub] for k, v in P.items()}
                    arrs.update(K=P_K[sub], label=P_label[sub], diam=P_diam[sub])
                    d_idx = dev(depth_of_pair[pos])
                    if win is None:
                        gather = {"depth": lambda i0, i1: depth_bank[d_idx[i0:i1]]}
                    else:
                        # image-grid windows of the test depth, gathered on
                        # the device per chunk
                        bh, bw = win
                        arrs["offs"] = offs[pos]
                        offs_d = dev(offs[pos].astype(np.int64))
                        ar_h = torch.arange(bh, device=device)
                        ar_w = torch.arange(bw, device=device)

                        def gather_win(i0, i1):
                            o = offs_d[i0:i1]
                            return depth_bank[d_idx[i0:i1, None, None],
                                              o[:, 0, None, None] + ar_h[None, :, None],
                                              o[:, 1, None, None] + ar_w[None, None, :]]
                        gather = {"depth": gather_win}
                    vsd_flat[sub] = _run_chunked(lambda **a: fn(**a, **vsd_kw), arrs,
                                                 len(sub), chunk, device, gather=gather)

                run_group(_vsd_win_pairs, np.where(use_win)[0], _VSD_WIN_CHUNK,
                          "window 128x128")
                pos_exact = np.where(~use_win)[0]
                if len(pos_exact):
                    # toolkit-exact pairs: the smallest image-grid bucket that
                    # holds the pair (counts equal the full image's), the
                    # full image when none does
                    sub = idx[pos_exact]
                    bucket_i, offs_sub, buckets = vsd_bbox_plan(
                        P["te"][sub], P["tg"][sub], P_K[sub], radii_c[P_label[sub]],
                        im_h, im_w)
                    offs_all = np.zeros((len(idx), 2), np.int32)
                    offs_all[pos_exact] = offs_sub
                    for bi, (bh, bw) in enumerate(buckets):
                        chunk = max(8, (_VSD_WIN_CHUNK * 128 * 128) // (bh * bw))
                        run_group(_vsd_bbox_pairs, pos_exact[bucket_i == bi], chunk,
                                  f"bbox {bh}x{bw}", win=(bh, bw), offs=offs_all)
                    run_group(_vsd_full_pairs, pos_exact[bucket_i < 0], full_chunk,
                              f"full {im_h}x{im_w}")
        phase_s["vsd"] += time.perf_counter() - t0

        # --- phase 3 (host): per-target, per-threshold matching ----------
        # A target with one estimate OR one GT: the toolkit's greedy
        # matching is "any pair under the threshold", so count(th) =
        # (min < th), from reduceat minima over the contiguous pair slices.
        # Only targets with ne > 1 AND ng > 1 run the greedy loop.
        t0 = time.perf_counter()
        offs = np.array([j["off"] for j in jobs], np.int64)
        mins_mssd = np.minimum.reduceat(mssd_flat, offs) if mssd_flat is not None else None
        mins_mspd = np.minimum.reduceat(mspd_flat, offs) if mspd_flat is not None else None
        mins_vsd = (np.minimum.reduceat(vsd_flat, offs, axis=0)
                    if vsd_flat is not None else None)
        matched_meta = []       # diameter per matched pair
        matched_label = []      # class label per matched pair
        for ji, j in enumerate(jobs):
            ne, ng, off = j["ne"], j["ng"], j["off"]
            sl = slice(off, off + ne * ng)
            simple = ne == 1 or ng == 1
            if simple:
                if mssd_flat is not None:
                    mssd_tp += mins_mssd[ji] < MSSD_THS * j["diam"]
                if mspd_flat is not None:
                    mspd_tp += mins_mspd[ji] < MSPD_THS * r_mspd
                if vsd_flat is not None and j["depth"] is not None:
                    vsd_tp += mins_vsd[ji][:, None] < VSD_THS[None, :]
            else:
                if mssd_flat is not None:
                    table = mssd_flat[sl].reshape(ne, ng)
                    for k, th in enumerate(MSSD_THS):
                        mssd_tp[k] += match_count(table, th * j["diam"])
                if mspd_flat is not None:
                    table = mspd_flat[sl].reshape(ne, ng)
                    for k, th in enumerate(MSPD_THS):
                        mspd_tp[k] += match_count(table, th * r_mspd)
                if vsd_flat is not None and j["depth"] is not None:
                    tabs = vsd_flat[sl].reshape(ne, ng, -1)
                    for ti in range(len(VSD_TAUS)):
                        for k, th in enumerate(VSD_THS):
                            vsd_tp[ti, k] += match_count(tabs[:, :, ti], th)

            # aux errors: matched once by min-add (custom-evaluator
            # semantics, not part of BOP AR)
            add_table = add_flat[sl].reshape(ne, ng)
            if simple:
                # one row: greedy = arg-min column; one column: the first
                # (highest-score) estimate takes the only GT
                jj = int(np.argmin(add_table)) if ne == 1 else 0
                matched_pairs.append(off + jj)
                matched_meta.append(j["diam"])
                matched_label.append(label_of[j["key"][2]])
                n_matched = 1
            else:
                used = set()
                n_matched = 0
                for i in range(ne):
                    cand = [(add_table[i, jj], jj) for jj in range(ng) if jj not in used]
                    if not cand:
                        break
                    _, jj = min(cand)
                    used.add(jj)
                    matched_pairs.append(off + i * ng + jj)
                    matched_meta.append(j["diam"])
                    matched_label.append(label_of[j["key"][2]])
                    n_matched += 1
            for _ in range(ng - n_matched):
                for k in err_rows:
                    err_rows[k].append((np.inf, j["diam"]))
        phase_s["matching"] += time.perf_counter() - t0

        # --- phase 4: the aux errors of the matched pairs ----------------
        if matched_pairs:
            t0 = time.perf_counter()
            mp = np.asarray(matched_pairs)
            cols = _run_chunked(
                lambda **a: _aux_pairs(**a, pts_bank=pts_bank, symR_b=symR_b,
                                       symV_b=symV_aux),
                {"Re": P["Re"][mp], "te": P["te"][mp], "Rg": P["Rg"][mp],
                 "tg": P["tg"][mp], "K": P_K[mp], "label": P_label[mp]},
                len(mp), _PAIR_CHUNK, device, pair_axis=-1)          # (5, n_matched)
            names = ("add", "adi", "re", "te", "proj")
            for row_i, name in enumerate(names):
                for v, d in zip(cols[row_i], matched_meta):
                    err_rows[name].append((float(v), d))
            matched_errs = {name: np.asarray(cols[row_i], np.float64)
                            for row_i, name in enumerate(names)}
            phase_s["aux"] += time.perf_counter() - t0

    out = {}
    if mssd_tar and "mssd" in errors:
        out["AR_mssd"] = float(np.mean(mssd_tp / mssd_tar))
    if mspd_tar and "mspd" in errors:
        out["AR_mspd"] = float(np.mean(mspd_tp / mspd_tar))
    if vsd_tar:
        out["AR_vsd"] = float(np.mean(vsd_tp / vsd_tar))
    ar_parts = [out[k] for k in ("AR_vsd", "AR_mssd", "AR_mspd") if k in out]
    if ar_parts:
        out["AR"] = float(np.mean(ar_parts))

    # custom evaluator recalls (reference thresholds: 2/5/10% diam, 2/5 deg/cm)
    if err_rows["add"]:
        for name in ("add", "adi"):
            errs = np.array([e for e, _ in err_rows[name]])
            diams = np.array([d for _, d in err_rows[name]])
            for th in (0.02, 0.05, 0.10):
                out[f"{name}_{int(th * 100)}"] = float(np.mean(errs < th * diams))
        re_errs = np.array([e for e, _ in err_rows["re"]])
        te_errs = np.array([e for e, _ in err_rows["te"]])
        out["re_2"] = float(np.mean(re_errs < 2.0))
        out["re_5"] = float(np.mean(re_errs < 5.0))
        out["te_2cm"] = float(np.mean(te_errs < 0.02))
        out["te_5cm"] = float(np.mean(te_errs < 0.05))
        pj = np.array([e for e, _ in err_rows["proj"]])
        for th in (2, 5, 10):
            out[f"proj_{th}"] = float(np.mean(pj < th))
        # ADD(-S) AUC up to 10 cm (the YCB-V convention)
        for name in ("add", "adi"):
            errs = np.array([e for e, _ in err_rows[name]])
            out[f"auc_{name}_10cm"] = auc_of_errors(errs, max_err=0.10)

    # precision tables (reference _eval_predictions_precision,
    # gdrn_custom_evaluator.py:811-960, DPOD-style): over matched
    # predictions only; "ad" is adi for objects with symmetries, else add
    if eval_precision and n_pairs and matched_pairs:
        diam_m = np.asarray(matched_meta, np.float64)
        sym_m = np.array([model_bank.sym_rotations[lb] is not None for lb in matched_label])
        ad = np.where(sym_m, matched_errs["adi"], matched_errs["add"])
        for th in (0.02, 0.05, 0.10):
            out[f"prec_ad_{int(th * 100)}"] = float(np.mean(ad < th * diam_m))
        for th in (2, 5, 10):
            out[f"prec_re_{th}"] = float(np.mean(matched_errs["re"] < th))
            out[f"prec_te_{th}"] = float(np.mean(matched_errs["te"] < th / 100.0))
            out[f"prec_rete_{th}"] = float(np.mean((matched_errs["re"] < th)
                                                   & (matched_errs["te"] < th / 100.0)))
            out[f"prec_proj_{th}"] = float(np.mean(matched_errs["proj"] < th))
    if stats is not None:
        total = time.perf_counter() - t_start
        stats.update(n_targets=len(targets), n_pairs=n_pairs, vsd_pairs=dict(vsd_buckets),
                     seconds=dict(phase_s, total=total),
                     targets_per_s=len(targets) / total if total > 0 else float("nan"),
                     device=str(device))
    return out


def auc_of_errors(errs: np.ndarray, max_err: float = 0.10, steps: int = 100) -> float:
    """Area under the accuracy-vs-threshold curve, thresholds in (0, max_err]
    (the PoseCNN/YCB-V ADD-S AUC)."""
    ths = np.linspace(0, max_err, steps + 1)[1:]
    return float(np.mean([(errs < t).mean() for t in ths]))


def per_object_scores(results, gts, model_bank, obj_ids=None, **kwargs):
    """Per-object score table and the object-count-weighted mean AR
    (reference test_utils.py's weighted averages)."""
    by_obj = sorted({g["obj_id"] for g in gts}) if obj_ids is None else obj_ids
    table, counts = {}, {}
    for oid in by_obj:
        g = [x for x in gts if x["obj_id"] == oid]
        r = [x for x in results if x["obj_id"] == oid]
        counts[oid] = len(g)
        table[oid] = score_bop_results(r, g, model_bank, **kwargs)
    ars = [(table[o].get("AR"), counts[o]) for o in by_obj if table[o].get("AR") is not None]
    if ars:
        total = sum(c for _, c in ars)
        table["weighted_mean_AR"] = float(sum(a * c for a, c in ars) / max(total, 1))
    return table


def _pose_arrays(ests, gt_list):
    Re = np.stack([np.asarray(e["R"], np.float32) for e in ests])
    te_ = np.stack([np.asarray(e["t"], np.float32).ravel() for e in ests])
    Rg = np.stack([np.asarray(g["R"], np.float32) for g in gt_list])
    tg = np.stack([np.asarray(g["t"], np.float32).ravel() for g in gt_list])
    return Re, te_, Rg, tg


def _pairwise(ests, gt_list, fn):
    """fn(R_est, t_est, R_gt, t_gt) on numpy pair arrays -> (n_est, n_gt)
    error table (the per-target form, kept as a test oracle)."""
    Re, te_, Rg, tg = _pose_arrays(ests, gt_list)
    ne, ng = len(ests), len(gt_list)
    out = fn(np.repeat(Re, ng, axis=0), np.repeat(te_, ng, axis=0),
             np.tile(Rg, (ne, 1, 1)), np.tile(tg, (ne, 1)))
    return np.asarray(out).reshape(ne, ng)


def match_count(table: np.ndarray, th: float) -> int:
    """BOP-toolkit match_poses for one correctness threshold
    (lib/pysixd/pose_matching.py:49-91): rows (estimates) are score-sorted;
    each row matches the unmatched column (GT) of LOWEST error among those
    under th. Returns the match count."""
    ne, ng = table.shape
    used = np.zeros(ng, bool)
    count = 0
    for i in range(ne):
        row = np.where(~used, table[i], np.inf)
        j = int(np.argmin(row))
        if row[j] < th:
            used[j] = True
            count += 1
    return count


def _error_table(ests, gt_list, e_name, pts, syms_R, syms_t, device="cuda"):
    """(n_est, n_gt) raw mssd/mspd table with FULL symmetry transforms
    (R, t) (lib/pysixd/misc.py get_symmetry_transformations)."""
    if not ests:
        return None
    n = len(ests) * len(gt_list)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    P = dev(np.tile(pts[None], (n, 1, 1)))
    sR = dev(np.tile(syms_R[None], (n, 1, 1, 1)))
    st = dev(np.tile(syms_t[None], (n, 1, 1)))
    sv = torch.ones((n, syms_R.shape[0]), dtype=torch.bool, device=device)
    if e_name == "mssd":
        def fn(Re, te_, Rg, tg):
            return mssd_batch(dev(Re), dev(te_), dev(Rg), dev(tg), P, sR, st, sv).cpu()
    else:
        K = dev(np.tile(np.asarray(ests[0].get("K", np.eye(3)), np.float32)[None],
                        (n, 1, 1)))

        def fn(Re, te_, Rg, tg):
            return mspd_batch(dev(Re), dev(te_), dev(Rg), dev(tg), K, P, sR, st, sv).cpu()
    return _pairwise(ests, gt_list, fn)
