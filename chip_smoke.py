#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gdrnpp_bop2022_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
checks each against its plain PyTorch version on the card, then serves a
few requests through the port's main path at the flagship width
(``Config()``: convnext_base, 256 -> 64, 21 classes, bf16, batch 64) with
weights drawn from a seed, and checks the flagship model on the card
against the same model on the CPU in fp32. Phases:

  1. device: name, versions, power limit; build the kernels;
  2. kernel vs plain on the card at the shapes the main path gives it;
  3. the serving slice: PNGs + detections on disk -> index_bop_split ->
     load_detections -> iter_test_batches -> run_gdrn_inference ->
     results_to_bop_rows -> save_bop_results, with launch counts;
  4. card vs CPU parity of the flagship model in fp32 (TF32 off).

Any failure raises (exit code 1). Without a CUDA device it exits 1 before
printing any result. The next-to-last line is the kernels' JSON record,
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
BATCH = 64              # tools/test_gdrn.py serves batches of 64 ROIs
N_IMAGES = 24
DETS_PER_IMAGE = 8      # 192 ROIs: 3 full batches (+ the warm-up pass)
LN_PER_FORWARD = 40     # convnext_base: stem + 3 downsamples + 36 blocks
# (rows per ROI, C, LayerNorms per forward) of convnext_base at 256x256
LN_SHAPES = ((4096, 128, 5), (1024, 256, 4), (256, 512, 28), (64, 1024, 3))
# B1 vs plain: fp32 within 1e-5 abs; bf16 within one bf16 ulp of the
# output (rounding the same fp32 value may land one ulp apart), + 1e-5
LN_TOL_F32 = 1e-5
# card vs CPU, fp32 flagship: 40 blocks of convs whose algorithms differ
# (cuDNN vs oneDNN) and sum in another order
PARITY_ROT_TOL = 1e-3
PARITY_REL_TOL = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    name = torch.cuda.get_device_name(0)
    log(f"[1/4] device: {name} x{torch.cuda.device_count()}  torch "
        f"{torch.__version__}  CUDA {torch.version.cuda}  python "
        f"{sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    from gdrnpp_bop2022_torch.ops import layer_norm as ln_mod
    t0 = time.perf_counter()
    ln_mod._kernel()                                # nvcc build + load
    log(f"[1/4] built csrc/layer_norm.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    return name, card


def _ln_case(rows, C, dtype, g):
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_ref
    x = (torch.randn(rows, C, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
    b = 0.1 * torch.randn(C, device="cuda", generator=g)
    y = layer_norm(x, w, b)
    ref = layer_norm_ref(x, w, b).float()
    torch.cuda.synchronize()
    err = (y.float() - ref).abs()
    if dtype == torch.float32:
        ok = bool((err <= LN_TOL_F32).all())
    else:
        _, e = torch.frexp(ref)
        ok = bool((err <= torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5).all())
    return x, w, b, float(err.max()), ok


def phase_kernels(card):
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_ref
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    cases = [(BATCH * r, C, dt, n) for r, C, n in LN_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(1001, C, dt, 0) for C in (96, 192, 384, 768)
              for dt in (torch.bfloat16, torch.float32)]
    for rows, C, dt, n in cases:
        x, w, b, err, ok = _ln_case(rows, C, dt, g)
        line = f"[2/4] B1 rows={rows} C={C} {str(dt)[6:]} max_abs_err={err:.3g}"
        if n and dt == torch.bfloat16:      # the main path's shapes: time them
            k = cuda_ms(lambda: layer_norm(x, w, b))
            p = cuda_ms(lambda: layer_norm_ref(x, w, b))
            ms, plain_ms, worst = ms + n * k, plain_ms + n * p, max(worst, err)
            line += f" kernel_ms={k:.4f} plain_ms={p:.4f}"
        log(line)
        check(ok, f"B1 disagrees with its plain version at rows={rows} C={C} "
                  f"{dt}: max abs err {err}")
    log(f"[2/4] B1 per forward at batch {BATCH} (40 LayerNorms, bf16): kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def _write_scene(root, rs):
    """A BOP test split of N_IMAGES 480x640 PNGs (YCB-V ids and camera) and
    a detections file with DETS_PER_IMAGE boxes per image."""
    import cv2
    from gdrnpp_bop2022_torch.bop.inout import save_json
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    meta = get_meta("ycbv")
    sdir = os.path.join(root, "test", "000048")
    os.makedirs(os.path.join(sdir, "rgb"))
    K = meta.camera_matrix.ravel().tolist()
    gt, cam, dets = {}, {}, {}
    yy, xx = np.mgrid[0:480, 0:640]
    for im in range(N_IMAGES):
        img = (np.stack([xx * 0.3 + im * 7, yy * 0.4, (xx + yy) * 0.2], -1)
               + rs.randint(0, 60, (480, 640, 3))) % 256
        cv2.imwrite(os.path.join(sdir, "rgb", f"{im:06d}.png"), img.astype(np.uint8))
        objs = rs.choice(np.arange(1, 22), DETS_PER_IMAGE, replace=False)
        gt[str(im)] = [{"obj_id": int(o), "cam_R_m2c": np.eye(3).ravel().tolist(),
                        "cam_t_m2c": [0.0, 0.0, 800.0]} for o in objs]
        cam[str(im)] = {"cam_K": K, "depth_scale": 0.1}
        boxes = []
        for o in objs:
            w, h = rs.uniform(40, 220, 2)
            boxes.append({"obj_id": int(o), "score": float(rs.uniform(0.3, 1.0)),
                          "time": 0.01, "bbox_est": [float(rs.uniform(-20, 600 - w)),
                                                     float(rs.uniform(-20, 440 - h)),
                                                     float(w), float(h)]})
        dets[f"48/{im}"] = boxes
    save_json(os.path.join(sdir, "scene_gt.json"), gt)
    save_json(os.path.join(sdir, "scene_camera.json"), cam)
    save_json(os.path.join(root, "dets.json"), dets)
    return meta, os.path.join(root, "test"), os.path.join(root, "dets.json")


def phase_slice(card, tmp):
    from gdrnpp_bop2022_torch.bop.inout import load_bop_results, save_bop_results
    from gdrnpp_bop2022_torch.config import Config
    from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split,
                                                        load_detections,
                                                        make_records_by_image)
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    from gdrnpp_bop2022_torch.engine.inference import (results_to_bop_rows,
                                                       run_gdrn_inference)
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    cfg = Config()
    pc = cfg.model.pose_net
    check(pc.backbone.name == "convnext_base" and pc.num_classes == 21
          and pc.input_res == 256 and pc.output_res == 64
          and cfg.model.compute_dtype == "bfloat16", "Config() is not the flagship")
    model = build_gdrn(cfg, device="cuda")
    model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    meta, split_dir, det_file = _write_scene(tmp, np.random.RandomState(SEED))
    by_im = make_records_by_image(index_bop_split(split_dir, meta))
    dets = load_detections(det_file, meta, top_k_per_obj=1)
    batches = iter_test_batches(by_im, dets, batch_size=BATCH)
    extents = np.random.RandomState(SEED + 1).uniform(0.05, 0.25, (21, 3))

    stats = {}
    layer_norm.launches = 0                       # count the main path only
    results = run_gdrn_inference(model, batches, extents,
                                 input_res=pc.input_res, output_res=pc.output_res,
                                 pixel_mean=cfg.model.pixel_mean,
                                 pixel_std=cfg.model.pixel_std,
                                 post_mode="direct", stats=stats)
    launches = layer_norm.launches
    n_rois = N_IMAGES * DETS_PER_IMAGE
    check(len(results) == n_rois, f"{len(results)} rows for {n_rois} detections")
    check(forwards[0] == stats["n_batches"] + 1, f"{forwards[0]} forwards for "
          f"{stats['n_batches']} batches + warm-up")
    check(launches == LN_PER_FORWARD * forwards[0],
          f"layer_norm launches {launches} != 40 x {forwards[0]} forwards")
    R = np.stack([r["R"] for r in results])
    t = np.stack([r["t"] for r in results])
    check(np.isfinite(R).all() and np.isfinite(t).all(), "non-finite pose")
    orth = float(np.abs(np.swapaxes(R, 1, 2) @ R - np.eye(3)).max())
    check(orth < 1e-3, f"|R^T R - I| = {orth}")
    csv = os.path.join(tmp, "poses.csv")
    save_bop_results(csv, results_to_bop_rows(results))
    check(len(load_bop_results(csv)) == n_rois, "CSV row count")
    log(f"[3/4] served {n_rois} ROIs ({N_IMAGES} images) in {stats['n_batches']} "
        f"batches of {BATCH} + warm-up: {forwards[0]} forwards, layer_norm "
        f"launches {launches} = 40 x {forwards[0]}; rows finite, "
        f"max|R^T R - I| = {orth:.2e}; CSV {len(results)} rows")
    log(f"[3/4] serving (ROI crop + forward + decode, host clock after "
        f"synchronize): {stats['rois_per_sec']:.1f} ROI/s, p50 "
        f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms per batch of "
        f"{BATCH}  [{card}]")

    # the model alone at batch 64, device time by CUDA events
    b0 = next(iter_test_batches(by_im, dets, batch_size=BATCH))
    from gdrnpp_bop2022_torch.engine.batching import build_test_batch
    dev = lambda a: torch.as_tensor(a).cuda()
    with torch.inference_mode():
        rb = build_test_batch(dev(b0["images"]), dev(b0["img_idx"]),
                              dev(b0["boxes_xyxy"]), dev(b0["Ks"]),
                              dev(b0["labels"]), dev(extents).float(),
                              input_res=pc.input_res, output_res=pc.output_res)
        fwd_ms = cuda_ms(lambda: model(**rb), iters=10)
    log(f"[3/4] GDRN forward alone at batch {BATCH}, bf16: {fwd_ms:.3f} ms = "
        f"{BATCH / fwd_ms * 1e3:.1f} ROI/s  [{card}]")
    return launches, rb


def phase_parity(rb):
    """Flagship in fp32 on the card (kernel) and on the CPU (plain path)."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace_cfg(Config(), {"model.compute_dtype": "float32"})
    batch = {k: v[:2].float() if v.is_floating_point() else v[:2]
             for k, v in rb.items()}
    outs = {}
    for device in ("cuda", "cpu"):
        m = build_gdrn(cfg, device=device)
        m.load_state_dict(seeded_state_dict(m, SEED), strict=True)
        with torch.inference_mode():
            o = m(**{k: v.to(device) for k, v in batch.items()})
        outs[device] = {k: v.float().cpu() for k, v in o.items() if v is not None}
        del m
    gpu, cpu = outs["cuda"], outs["cpu"]
    errs = {}
    for k in ("rot", "trans", "centroid_rel", "z_rel", "vis_mask", "full_mask",
              "coor_x", "coor_y", "coor_z", "region"):
        d = float((gpu[k] - cpu[k]).abs().max())
        scale = max(float(cpu[k].abs().max()), 1.0)
        errs[k] = d
        tol = PARITY_ROT_TOL if k == "rot" else PARITY_REL_TOL * scale
        check(torch.isfinite(gpu[k]).all() and d <= tol,
              f"card vs CPU {k}: max abs diff {d} > {tol}")
    log("[4/4] fp32 flagship, 2 ROIs, card (B1 kernel) vs CPU (plain), TF32 "
        "off: max abs diff " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 1
    import gdrnpp_bop2022_torch  # noqa: F401  (fails here outside a checkout)
    torch.manual_seed(SEED)
    name, card = phase_device()
    ln = phase_kernels(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches, rb = phase_slice(card, tmp)
    phase_parity(rb)
    jax_mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax"))
    check(not jax_mods, f"the port imported {jax_mods[:3]}")
    print(json.dumps({"kernels": [{
        "name": "layer_norm", "route": "cuda",
        "source": "gdrnpp_bop2022_torch/csrc/layer_norm.cu",
        "replaces": "gdrnpp_bop2022_tpu/ops/pallas_ln.py:26",
        "launches": launches, "max_abs_err": ln["max_abs_err"],
        "ms": ln["ms"], "plain_ms": ln["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
