"""Inference driver: detections -> poses -> BOP CSV rows.

Port of ``gdrnpp_bop2022_tpu/engine/inference.py`` for the RGB model and the
RGB-D dual-stream model (``with_depth_input``), with every post mode of the
reference evaluator (GDRN_Evaluator.process branches, gdrn_evaluator.py:
180/241/373/461): ``direct`` (the pose straight from the network),
``ransac_pnp``, ``uncertainty_pnp`` and ``net_iter_pnp`` (the pose solved
again from the dense XYZ prediction, ``eval/pnp_eval.py``) and
``depth_refine`` (the translation refined against the sensor depth through
kernel B2).

Timing keeps the reference's BOP semantics (gdrn_evaluator.py:598-610):
per-instance time = detector time + GDRN compute, then normalised per
image to the max over its instances. A warm-up pass runs the first batch
untimed, so no row carries one-time set-up. Clocks are read only after
``torch.cuda.synchronize()`` (the host clock around work that ends in a
synchronise, or copies back to the host).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..eval.pnp_eval import (depth_refine_batch, pose_from_dense_net_iter,
                             pose_from_dense_ransac, pose_from_dense_uncertainty)
from ..models.gdrn import get_mask_prob
from ..ops.crop import affine_grid_from_boxes, roi_crop_resize
from .batching import build_depth_rois, build_test_batch, roi_coord_2d_from_grid

POST_MODES = ("direct", "ransac_pnp", "uncertainty_pnp", "net_iter_pnp", "depth_refine")
PNP_MODES = ("ransac_pnp", "uncertainty_pnp", "net_iter_pnp")


def decode_dense_outputs(out: dict, mask_loss_type: str = "L1"):
    """Dense geo-head outputs -> (xyz (B,H,W,3) in [0,1], mask_prob (B,H,W)).

    Regression coords (one channel) pass through; binned coords decode as
    argmax bin / (bins - 1), with the background bin -> 0.
    """
    def decode_coor(c):
        if c.shape[-1] == 1:
            return c[..., 0]
        n_bins = c.shape[-1] - 1
        idx = torch.argmax(c, dim=-1)
        val = idx.float() / max(n_bins - 1, 1)
        return torch.where(idx == n_bins, torch.zeros_like(val), val)

    xyz = torch.stack([decode_coor(out["coor_x"]), decode_coor(out["coor_y"]),
                       decode_coor(out["coor_z"])], dim=-1)
    mask_prob = get_mask_prob(out["vis_mask"][..., None], mask_loss_type)[..., 0]
    return xyz, mask_prob


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_gdrn_inference(
    model: nn.Module,
    batches: Iterable[dict],        # from datasets.test_loader.iter_test_batches
    extents_bank: np.ndarray,       # (C, 3)
    input_res: int = 256,
    output_res: int = 64,
    pixel_mean=(0.0, 0.0, 0.0),
    pixel_std=(255.0, 255.0, 255.0),
    post_mode: str = "direct",      # one of POST_MODES
    model_bank=None,                # ModelBank (verts, faces), for depth_refine
    depth_refine_iters: int = 2,
    depth_refine_threshold: float = 0.8,
    mask_loss_type: str = "L1",
    with_depth_input: bool = False,  # RGB-D dual-stream model: feed roi_depth
    bp_depth: bool = True,
    stats: Optional[dict] = None,   # out-param: serving stats
    pipeline_depth: int = 1,        # >1: keep this many batches in flight
    coord_2d_type: str = "abs",
    seed: int = 0,                  # seeds RANSAC's draws (post_mode="ransac_pnp")
) -> List[dict]:
    """Run pose inference over all test batches on the model's device.

    Returns BOP result rows (R (3,3), t in meters; the CSV conversion to mm
    happens in ``results_to_bop_rows``). pipeline_depth=1 times each batch
    on its own and stamps its rows with it; pipeline_depth > 1 launches
    batches without waiting, so the host loads batch k+1 while the device
    runs batch k, and rows carry the amortised wall-clock per ROI.

    With ``with_depth_input`` or ``post_mode="depth_refine"`` the batches
    carry "depths" (M, H, W) in meters. The dual-stream model gets the
    backprojected depth ROI at input_res; depth refinement crops the sensor
    depth at output_res (nearest) and renders the label's mesh from the
    bank ``depth_refine_iters`` times per batch. The PnP modes solve the pose
    again from the decoded XYZ and mask on the full-image 2D coordinates;
    RANSAC draws its subsets from a generator on the model's device seeded
    with ``seed``.
    """
    if post_mode not in POST_MODES:
        raise ValueError(f"post_mode={post_mode!r}: one of {', '.join(POST_MODES)}")
    device = next(model.parameters()).device
    generator = (torch.Generator(device=device).manual_seed(seed)
                 if post_mode == "ransac_pnp" else None)
    extents = torch.as_tensor(np.asarray(extents_bank), dtype=torch.float32,
                              device=device)
    if post_mode == "depth_refine":
        if model_bank is None:
            raise ValueError("post_mode='depth_refine' needs the model bank")
        bank_verts = torch.as_tensor(np.asarray(model_bank.verts), dtype=torch.float32,
                                     device=device)
        bank_faces = torch.as_tensor(np.asarray(model_bank.faces), dtype=torch.int32,
                                     device=device)
    model.eval()

    @torch.inference_mode()
    def dispatch(batch):
        """One device pass: ROI prep + forward. Returns device tensors,
        possibly still being computed."""
        put = lambda a: torch.as_tensor(a).to(device, non_blocking=True)
        img_idx, Ks, labels = put(batch["img_idx"]), put(batch["Ks"]), put(batch["labels"])
        rb = build_test_batch(
            put(batch["images"]), img_idx, put(batch["boxes_xyxy"]), Ks, labels,
            extents, input_res=input_res, output_res=output_res,
            pixel_mean=tuple(pixel_mean), pixel_std=tuple(pixel_std),
            coord_2d_type=coord_2d_type)
        scales = output_res / rb["resize_ratios"]
        depths = None
        if with_depth_input or post_mode == "depth_refine":
            if "depths" not in batch:
                raise ValueError("RGB-D inference needs batches with 'depths' "
                                 "(iter_test_batches(with_depth=True))")
            depths = put(batch["depths"])
        if with_depth_input:
            rb["roi_depth"] = build_depth_rois(depths, img_idx, rb["roi_centers"],
                                               scales, Ks, input_res=input_res,
                                               bp_depth=bp_depth)
        out = model(**rb)
        rot, trans = out["rot"], out["trans"]
        if post_mode in PNP_MODES:
            xyz, mask_prob = decode_dense_outputs(out, mask_loss_type)
            # the correspondences need ABSOLUTE normalised image coords
            # whatever the model's input parameterisation (the reference
            # evaluator rebuilds them from the full image, gdrn_evaluator.py:270-280)
            im_h, im_w = batch["images"].shape[1:3]
            c2d = rb["roi_coord_2d"]
            if coord_2d_type != "abs":
                c2d = roi_coord_2d_from_grid(
                    affine_grid_from_boxes(rb["roi_centers"], scales, output_res), im_w, im_h)
            im_wh = torch.tensor([im_w, im_h], dtype=torch.float32,
                                 device=device).expand(rot.shape[0], 2)
            args = (mask_prob, xyz, c2d, im_wh, rb["roi_extents"], Ks.float())
            if post_mode == "ransac_pnp":
                rot, trans, _ = pose_from_dense_ransac(*args, generator=generator)
            elif post_mode == "net_iter_pnp":
                rot, trans = pose_from_dense_net_iter(*args, R0=rot, t0=trans)
            else:
                rot, trans = pose_from_dense_uncertainty(*args, R0=rot, t0=trans)
        elif post_mode == "depth_refine":
            xyz, mask_prob = decode_dense_outputs(out, mask_loss_type)
            d_crop = roi_crop_resize(depths[..., None], rb["roi_centers"], scales,
                                     output_res, method="nearest",
                                     img_idx=img_idx)[..., 0]
            lab = labels.long()
            trans = depth_refine_batch(
                rot, trans, mask_prob, xyz, d_crop, Ks.float(), rb["roi_centers"],
                scales, bank_verts[lab], bank_faces[lab], rb["roi_extents"],
                iters=depth_refine_iters, threshold=depth_refine_threshold,
                out_res=output_res)
        return rot, trans

    def fetch(rot, trans):
        _sync(device)
        return rot.cpu().numpy(), trans.cpu().numpy()

    results = []
    per_image_rows: Dict[tuple, list] = {}
    n_instances = 0
    n_batches = 0
    total_compute = 0.0
    warmed = False
    amortize = pipeline_depth > 1
    t_wall0 = None
    inflight: deque = deque()
    # per-batch latency samples (seconds, n_valid): sync mode measures
    # dispatch -> ready; pipelined mode dispatch -> drained, queue included
    lat_samples: list = []

    def emit(batch, rot, trans, dt):
        nonlocal n_instances, n_batches
        n_batches += 1
        n_valid = int(batch["valid"].sum())
        per_roi_time = 0.0 if amortize else dt / max(n_valid, 1)
        n_instances += n_valid
        for i in range(n_valid):
            m = batch["metas"][i]
            row = {
                "scene_id": m.scene_id, "im_id": m.im_id, "obj_id": m.obj_id,
                "score": m.score, "R": rot[i], "t": trans[i],
                "time": m.det_time + per_roi_time,
                "K": batch["Ks"][i],
            }
            results.append(row)
            per_image_rows.setdefault((m.scene_id, m.im_id), []).append(row)

    def drain_one():
        b2, (r2, t2), td = inflight.popleft()
        rot2, trans2 = fetch(r2, t2)
        lat_samples.append((time.perf_counter() - td, int(b2["valid"].sum())))
        emit(b2, rot2, trans2, 0.0)

    for batch in batches:
        if not warmed:
            # warm-up pass: absorbs one-time set-up (kernel build, cuDNN
            # algorithm choice) so no row carries it; re-run timed below
            fetch(*dispatch(batch))
            warmed = True
            _sync(device)
            t_wall0 = time.perf_counter()
        if amortize:
            inflight.append((batch, dispatch(batch), time.perf_counter()))
            while len(inflight) >= pipeline_depth:
                drain_one()
        else:
            t0 = time.perf_counter()
            rot, trans = fetch(*dispatch(batch))
            dt = time.perf_counter() - t0
            total_compute += dt
            lat_samples.append((dt, int(batch["valid"].sum())))
            emit(batch, rot, trans, dt)
    while inflight:
        drain_one()
    if amortize and t_wall0 is not None:
        total_compute = time.perf_counter() - t_wall0
        per_roi = total_compute / max(n_instances, 1)
        for row in results:
            row["time"] += per_roi

    # normalise time per image to the max over its instances
    for rows in per_image_rows.values():
        t_max = max(r["time"] for r in rows)
        for r in rows:
            r["time"] = t_max
    if stats is not None:
        lat_ms = {}
        if lat_samples:
            # per-OBJECT latency: each batch latency counts once per ROI
            per_obj = np.repeat([s for s, _ in lat_samples],
                                [max(n, 1) for _, n in lat_samples])
            lat_ms = {"p50_ms": float(np.percentile(per_obj, 50) * 1e3),
                      "p99_ms": float(np.percentile(per_obj, 99) * 1e3),
                      "mean_ms": float(per_obj.mean() * 1e3)}
        stats.update(
            n_instances=n_instances, n_batches=n_batches,
            compute_s=total_compute,
            rois_per_sec=(n_instances / total_compute
                          if total_compute > 0 else float("nan")),
            device=str(device), **lat_ms)
    return results


def results_to_bop_rows(results: List[dict]) -> List[dict]:
    """Convert meters -> mm for BOP CSV emission."""
    return [{**r, "t": np.asarray(r["t"]) * 1000.0} for r in results]
