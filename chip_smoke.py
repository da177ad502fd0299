#!/usr/bin/env python3
"""Smoke run of the PyTorch port (gdrnpp_bop2022_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --timing-only ROOT

Builds the port's hand-written kernels from the sources in this checkout,
checks each against its plain PyTorch version on the card, then drives the
port's two served paths with weights drawn from a seed:

  * RGB: the flagship ``Config()`` (convnext_base, 256 -> 64, 21 classes,
    bf16, batch 64), ``post_mode="direct"``;
  * RGB-D: ``configs.ycbv_convnext_base_rgbd()`` (two convnext_base, concat
    fusion, bf16, batch 64), ``post_mode="depth_refine"`` against the depth
    PNGs and a bank of 21 synthetic ellipsoid meshes of 4096 faces,

and checks the models on the card against the same models on the CPU in
fp32. Phases:

  1. device: name, versions, power limit; build both kernels (one nvcc
     each, started together);
  2. B1 (LayerNorm) vs plain at the shapes the main paths give it, on both
     of its paths (16-byte vectors; one element per access for C = 100 and
     an input offset by one element), with hot (device time of back-to-back
     calls) and cold (L2 flushed before each call) times;
  3. B2 (rasterizer) vs plain, both modes: the flagship depth-refine batch
     (64 ROIs, 64x64, 4096-face meshes), a ragged 54x72 case, 2 ROIs at
     480x640 and an adversarial seam scene (edges through pixel centres,
     faces across tile borders); the pack kernel's output against the torch
     packing and the cull rule bit for bit; faces per tile after culling;
  4. the RGB slice: PNGs + detections on disk -> index_bop_split ->
     load_detections -> iter_test_batches -> run_gdrn_inference ->
     results_to_bop_rows -> save_bop_results, with launch counts;
  5. the RGB-D slice: the same with depth PNGs, the model bank from PLY
     files, the dual-stream model and depth refinement, with launch counts;
  6. depth refinement at batch 64 from GT R and GT t + 4 cm in z, through
     B2 and through the plain rasterizer;
  7. card vs CPU parity of the RGB and the RGB-D flagship in fp32.

The scene's sensor depth is analytic (ray-ellipsoid), never rendered by the
kernel under test. Any failure raises (exit code 1). Without a CUDA device
it exits 1 before printing any result. The next-to-last line is the
kernels' JSON record, the last line is {"ok": true, "device": {...}}.

``--timing-only ROOT`` imports the package from the checkout at ROOT (this
one, or an earlier commit unpacked with ``git archive``), builds its
kernels and prints, as its last line, a JSON record of B1's and B2's times
at the flagship shapes through the wrappers that every version has
(``layer_norm``, ``render_depth_xyz_cuda``): two versions compared in one
call on one card, in turns.
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
# B2 vs plain: identical silhouettes; depth 1e-5 m and xyz 1e-4 m where
# hit (the JAX package's Pallas-vs-XLA bounds); both round each product
# alike (no FMA), so they are expected to agree exactly
RASTER_DEPTH_TOL = 1e-5
RASTER_XYZ_TOL = 1e-4
# the plain rasterizer on the card: larger blocks than its CPU default
PLAIN_MAX_BLOCK = 1 << 24
# fp32 operations of one pixel-face test that every valid face needs: two
# edge functions (4 sub, 2 mul, 1 sub, 1 mul each) and w2 (2 sub)
RASTER_OPS_PER_TEST = 18
RASTER_TILE = (32, 8)     # csrc/raster.cu's kTileW, kTileH
H100_FP32_FLOPS = 67e12   # dense fp32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12
# cold timing: a 256 MB write evicts the 50 MB L2 before each call; the card
# then spins ~0.5 ms so the call is queued before its start event
FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 1_000_000
# card vs CPU, fp32 flagship: 40 blocks of convs whose algorithms differ
# (cuDNN vs oneDNN) and sum in another order
PARITY_ROT_TOL = 1e-3
PARITY_REL_TOL = 1e-3
# the synthetic RGB-D scene: 21 ellipsoids of 4096 faces (n_lat 33, n_lon 64)
MESH_LAT, MESH_LON = 33, 64
REFINE_OFFSET_M = 0.04
REFINE_T_TOL = 1e-5       # refined t, B2 vs the plain rasterizer (m)


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


def cold_ms(fn, reps=10):
    """Mean device time of single calls of fn() with the L2 cache flushed
    before each, by CUDA events around each call."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    del flush
    return total / reps


def device_ms(fn):
    """Device time per call of fn(), summed over every kernel it launches."""
    return kernel_ms(fn, ("",))[""]


def kernel_ms(fn, names, iters=20):
    """Device time per call of fn() in the kernels whose names contain each
    of `names`, by torch.profiler over `iters` back-to-back calls (None where
    no such kernel shows)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        us = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
                 for e in prof.key_averages() if n in e.key)
        out[n] = us / iters / 1e3 if us else None
    return out


def phase_device():
    name = torch.cuda.get_device_name(0)
    log(f"[1/7] device: {name} x{torch.cuda.device_count()}  torch "
        f"{torch.__version__}  CUDA {torch.version.cuda}  python "
        f"{sys.version.split()[0]}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    log(card)
    from gdrnpp_bop2022_torch.utils.cuda_build import (build_kernel_libraries,
                                                      load_kernel_library)
    t0 = time.perf_counter()
    build_kernel_libraries(["layer_norm", "raster"])    # nvcc, both at once
    for lib in ("layer_norm", "raster"):
        load_kernel_library(lib)
    log(f"[1/7] built csrc/layer_norm.cu and csrc/raster.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    return name, card


# ---------------------------------------------------------------------------
# B1: LayerNorm
# ---------------------------------------------------------------------------

def _ln_case(rows, C, dtype, g, offset=0):
    """B1 vs plain on x (rows, C) drawn from g; offset > 0 starts x that many
    elements into its buffer (not 16-byte aligned: the scalar path)."""
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_ref
    buf = (torch.randn(rows * C + offset, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    x = buf[offset:].view(rows, C)
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


def ln_times(card):
    """B1 and F.layer_norm at the main path's bf16 shapes: hot (device time
    of back-to-back calls, by the profiler: timed by events, calls of tens
    of us measure the host's enqueue) and cold (L2 flushed, events) ms per
    forward of 40 LayerNorms, the plain version's hot time, a copy_ of the
    same bytes cold, and the bytes bound. Only `layer_norm` and
    `layer_norm_ref` of the package are called."""
    import torch.nn.functional as F
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_ref
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    t = dict.fromkeys(("ms", "cold_ms", "plain_ms", "library_ms", "library_cold_ms",
                       "copy_cold_ms"), 0.0)
    n_bytes = 0
    for r, C, n in LN_SHAPES:
        x = (torch.randn(BATCH * r, C, device="cuda", generator=g) * 2 + 0.5).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
        b = 0.1 * torch.randn(C, device="cuda", generator=g)
        wb, bb = w.bfloat16(), b.bfloat16()     # F.layer_norm takes one dtype
        k = device_ms(lambda: layer_norm(x, w, b))
        kc = cold_ms(lambda: layer_norm(x, w, b))
        p = device_ms(lambda: layer_norm_ref(x, w, b))
        lib = device_ms(lambda: F.layer_norm(x, (C,), wb, bb, 1e-6))
        libc = cold_ms(lambda: F.layer_norm(x, (C,), wb, bb, 1e-6))
        y = torch.empty_like(x)         # a copy of the same bytes: what the card reaches
        cp = cold_ms(lambda: y.copy_(x))
        for key, v in zip(t, (k, kc, p, lib, libc, cp)):
            t[key] += n * v
        n_bytes += n * (2 * x.numel() * x.element_size() + 2 * C * 4)
        log(f"[2/7] B1 rows={BATCH * r} C={C} bfloat16 x{n}: kernel hot {k:.4f} ms cold "
            f"{kc:.4f} ms, plain {p:.4f} ms, F.layer_norm hot {lib:.4f} ms cold {libc:.4f} ms,"
            f" copy_ cold {cp:.4f} ms")
    t["bound_ms"] = n_bytes / H100_BYTES_PER_S * 1e3
    log(f"[2/7] B1 per forward at batch {BATCH} (40 LayerNorms, bf16): kernel hot "
        f"{t['ms']:.4f} ms, cold {t['cold_ms']:.4f} ms ({100 * t['bound_ms'] / t['cold_ms']:.1f}% "
        f"of the bound cold); plain {t['plain_ms']:.4f} ms; F.layer_norm hot "
        f"{t['library_ms']:.4f} ms, cold {t['library_cold_ms']:.4f} ms; copy_ of the same "
        f"bytes cold {t['copy_cold_ms']:.4f} ms; bound "
        f"{t['bound_ms']:.4f} ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s)  [{card}]")
    return t


def phase_kernels(card):
    from gdrnpp_bop2022_torch.ops.layer_norm import _vector_path
    g = torch.Generator(device="cuda").manual_seed(SEED)
    worst = 0.0
    cases = [(BATCH * r, C, dt, 0) for r, C, _ in LN_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(1001, C, dt, 0) for C in (96, 192, 384, 768)
              for dt in (torch.bfloat16, torch.float32)]
    # the scalar path: C = 100 in bf16 (not whole 16-byte vectors), x one
    # element into its buffer
    cases += [(r, C, dt, off) for r, C, off in ((4099, 100, 0), (BATCH * 4096, 128, 1),
                                               (777, 1024, 1))
              for dt in (torch.bfloat16, torch.float32)]
    for rows, C, dt, off in cases:
        x, w, b, err, ok = _ln_case(rows, C, dt, g, off)
        vec = _vector_path(x, torch.empty_like(x), w, b)
        want = off == 0 and C * x.element_size() % 16 == 0
        check(vec == want, f"B1 path for C={C} {dt} offset {off}: vector={vec}")
        worst = max(worst, err)
        log(f"[2/7] B1 rows={rows} C={C} {str(dt)[6:]} offset={off} "
            f"{'vector' if vec else 'scalar'} path: max_abs_err={err:.3g}")
        check(ok, f"B1 disagrees with its plain version at rows={rows} C={C} "
                  f"{dt} offset {off}: max abs err {err}")
    t = ln_times(card)
    t["max_abs_err"] = worst
    t["bound_by"] = "bytes"
    return t


# ---------------------------------------------------------------------------
# the synthetic RGB-D scene: ellipsoid meshes, analytic depth
# ---------------------------------------------------------------------------

def ellipsoid_mesh(axes_mm):
    """UV-tessellated ellipsoid: 2 + (MESH_LAT - 1) * MESH_LON vertices,
    2 * MESH_LON * (MESH_LAT - 1) faces (4096), outward winding."""
    th = np.linspace(0, np.pi, MESH_LAT + 1)[1:-1]
    ph = np.linspace(0, 2 * np.pi, MESH_LON, endpoint=False)
    ring = np.stack([np.outer(np.sin(th), np.cos(ph)), np.outer(np.sin(th), np.sin(ph)),
                     np.repeat(np.cos(th)[:, None], MESH_LON, 1)], -1).reshape(-1, 3)
    pts = np.concatenate([[[0, 0, 1]], ring, [[0, 0, -1]]]) * np.asarray(axes_mm)
    n, faces = MESH_LON, []
    for j in range(n):
        k = (j + 1) % n
        faces.append([0, 1 + j, 1 + k])
        for i in range(MESH_LAT - 2):
            a, b = 1 + i * n + j, 1 + i * n + k
            faces += [[a, a + n, b + n], [a, b + n, b]]
        last = 1 + (MESH_LAT - 2) * n
        faces.append([last + j, len(pts) - 1, last + k])
    return pts, np.asarray(faces)


def write_ply(path, pts, faces):
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\nend_header\n").encode())
        f.write(np.asarray(pts, "<f4").tobytes())
        rec = np.zeros(len(faces), [("n", "u1"), ("i", "<i4", 3)])
        rec["n"], rec["i"] = 3, faces
        f.write(rec.tobytes())


def pixel_rays(K, us, vs):
    """Camera rays (N, 3) with z = 1 through pixel coords us, vs (N,)."""
    y = (vs - K[1, 2]) / K[1, 1]
    x = (us - K[0, 2] - K[0, 1] * y) / K[0, 0]
    return np.stack([x, y, np.ones_like(x)], -1)


def ellipsoid_hits(rays, R, t, axes_m):
    """Nearest ray-ellipsoid hit: (depth (N,), 0 on a miss; object-frame
    point (N, 3)). rays (N, 3) with z = 1, pose R (3, 3), t (3,) meters."""
    m = rays @ R                       # R^T d
    n = R.T @ t
    A = 1.0 / np.square(axes_m)
    a = (m * m * A).sum(1)
    b = -2.0 * (m * n * A).sum(1)
    c = (n * n * A).sum() - 1.0
    disc = b * b - 4 * a * c
    s = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a)
    hit = (disc >= 0) & (s > 0)
    return np.where(hit, s, 0.0), s[:, None] * m - n


def random_rotation(rs):
    q, _ = np.linalg.qr(rs.randn(3, 3))
    return q * np.sign(np.linalg.det(q))


def write_models(models_dir, axes_mm):
    """The 21 ellipsoid models as PLY files + models_info.json (mm)."""
    from gdrnpp_bop2022_torch.bop.inout import save_json
    os.makedirs(models_dir)
    info = {}
    for i, a in enumerate(axes_mm):
        pts, faces = ellipsoid_mesh(a)
        write_ply(os.path.join(models_dir, f"obj_{i + 1:06d}.ply"), pts, faces)
        info[str(i + 1)] = {"diameter": float(2 * a.max()), "min_x": -a[0], "min_y": -a[1],
                            "min_z": -a[2], "size_x": 2 * a[0], "size_y": 2 * a[1],
                            "size_z": 2 * a[2]}
    save_json(os.path.join(models_dir, "models_info.json"), info)


def make_rgbd_scene(root, rs):
    """A BOP test split of N_IMAGES 480x640 RGB + depth PNGs (YCB-V ids and
    camera, depth_scale 0.1) with DETS_PER_IMAGE ellipsoids each, the 21
    models as PLY + models_info.json, and a detections file."""
    import cv2
    from gdrnpp_bop2022_torch.bop.inout import save_json
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    meta = get_meta("ycbv")
    K = meta.camera_matrix.astype(np.float64)
    axes_mm = rs.uniform(25.0, 100.0, (21, 3))
    models_dir = os.path.join(root, "models")
    write_models(models_dir, axes_mm)

    sdir = os.path.join(root, "test", "000048")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(sdir, sub))
    H, W = meta.height, meta.width
    gt, cam, dets = {}, {}, {}
    yy, xx = np.mgrid[0:H, 0:W]
    for im in range(N_IMAGES):
        depth = np.zeros((H, W))
        shade = np.zeros((H, W))
        objs = rs.choice(np.arange(1, 22), DETS_PER_IMAGE, replace=False)
        gt[str(im)], boxes = [], []
        for o in objs:
            ax = axes_mm[o - 1] * 1e-3
            R = random_rotation(rs)
            z = rs.uniform(0.7, 1.3)
            u, v = rs.uniform(90, W - 90), rs.uniform(90, H - 90)
            t = z * pixel_rays(K, np.array([u]), np.array([v]))[0]
            r = int(K[0, 0] * ax.max() / (z - ax.max())) + 2
            x0, x1 = max(int(u) - r, 0), min(int(u) + r + 1, W)
            y0, y1 = max(int(v) - r, 0), min(int(v) + r + 1, H)
            d, _ = ellipsoid_hits(pixel_rays(K, xx[y0:y1, x0:x1].ravel().astype(float),
                                             yy[y0:y1, x0:x1].ravel().astype(float)),
                                  R, t, ax)
            d = d.reshape(y1 - y0, x1 - x0)
            win = depth[y0:y1, x0:x1]
            front = (d > 0) & ((win == 0) | (d < win))
            win[front] = d[front]
            shade[y0:y1, x0:x1][front] = 60 + 9 * o
            ys, xs = np.nonzero(d > 0)
            check(len(xs) > 0, "an object of the scene is not in view")
            bx, by = x0 + xs.min(), y0 + ys.min()
            boxes.append({"obj_id": int(o), "score": float(rs.uniform(0.3, 1.0)),
                          "time": 0.01, "bbox_est": [float(bx + rs.uniform(-3, 3)),
                                                     float(by + rs.uniform(-3, 3)),
                                                     float(xs.max() - xs.min() + 1),
                                                     float(ys.max() - ys.min() + 1)]})
            gt[str(im)].append({"obj_id": int(o), "cam_R_m2c": R.ravel().tolist(),
                                "cam_t_m2c": (t * 1000).tolist()})
        img = (np.stack([shade + xx * 0.1, shade * 0.8 + yy * 0.1, shade * 0.6], -1)
               + rs.randint(0, 30, (H, W, 3))) % 256
        cv2.imwrite(os.path.join(sdir, "rgb", f"{im:06d}.png"), img.astype(np.uint8))
        cv2.imwrite(os.path.join(sdir, "depth", f"{im:06d}.png"),
                    np.round(depth * 10000).astype(np.uint16))   # 0.1 mm units
        cam[str(im)] = {"cam_K": K.ravel().tolist(), "depth_scale": 0.1}
        dets[f"48/{im}"] = boxes
    save_json(os.path.join(sdir, "scene_gt.json"), gt)
    save_json(os.path.join(sdir, "scene_camera.json"), cam)
    save_json(os.path.join(root, "dets.json"), dets)
    return {"meta": meta, "K": K, "axes_mm": axes_mm, "models_dir": models_dir,
            "split_dir": os.path.join(root, "test"),
            "det_file": os.path.join(root, "dets.json")}


def refine_batch(scene, bank, rs, n=BATCH, out_res=64):
    """A depth-refine batch at GT: per ROI a label, GT pose, crop around the
    projected centre, and the analytic sensor depth, mask and normalised
    object XYZ at the crop's pixels (what a perfect network would give)."""
    K = scene["K"]
    labels = rs.randint(0, 21, n)
    R = np.stack([random_rotation(rs) for _ in range(n)])
    z = rs.uniform(0.6, 1.2, n)
    t = np.stack([rs.uniform(-0.08, 0.08, n) * z, rs.uniform(-0.06, 0.06, n) * z, z], 1)
    uvw = t @ K.T
    centers = uvw[:, :2] / uvw[:, 2:]
    ax = scene["axes_mm"][labels] * 1e-3
    scales = 1.5 * K[0, 0] * 2 * ax.max(1) / z
    step = scales / out_res
    off = np.arange(out_res) - out_res * 0.5
    depth = np.zeros((n, out_res, out_res))
    xyz = np.zeros((n, out_res, out_res, 3))
    for i in range(n):
        gx = centers[i, 0] + off[None, :] * step[i]
        gy = centers[i, 1] + off[:, None] * step[i]
        gx, gy = np.broadcast_arrays(gx, gy)
        d, q = ellipsoid_hits(pixel_rays(K, gx.ravel(), gy.ravel()), R[i], t[i], ax[i])
        hit = (d > 0)[:, None]
        depth[i] = d.reshape(out_res, out_res)
        xyz[i] = np.where(hit, q / (2 * ax[i]) + 0.5, 0.0).reshape(out_res, out_res, 3)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    lab = torch.as_tensor(labels, device="cuda")
    return {"R": f32(R), "t": f32(t), "mask": f32(depth > 0), "xyz": f32(xyz),
            "depth": f32(depth), "K": f32(np.tile(K, (n, 1, 1))), "centers": f32(centers),
            "scales": f32(scales), "verts": f32(bank.verts)[lab],
            "faces": torch.as_tensor(bank.faces, device="cuda")[lab],
            "extents": f32(bank.extents)[lab], "out_res": out_res}


# ---------------------------------------------------------------------------
# B2: the rasterizer
# ---------------------------------------------------------------------------

def _seam_grid(s, off, flip, z_of_u):
    """A grid of spacing s px from -s to 64 + s, vertices at pixel coords
    offset by off, split into triangles along one diagonal or the other."""
    g = np.arange(-s, 64 + 2 * s, s) + off
    m = len(g)
    gx, gy = np.meshgrid(g, g)
    u, v = gx.ravel(), gy.ravel()
    z = z_of_u(u)
    pts = np.stack([u * z / 512.0, v * z / 512.0, z], 1)
    q = (np.arange(m - 1)[:, None] * m + np.arange(m - 1)).ravel()
    a, b, c, d = q, q + 1, q + m, q + m + 1
    tris = [(a, b, c), (b, d, c)] if flip else [(a, b, d), (a, d, c)]
    return pts, np.concatenate([np.stack(t, 1) for t in tris])


def seam_scene(n=8, device="cuda"):
    """An adversarial B2 input at 64x64 with K = diag(512, 512, 1), R = I,
    t = 0. Per ROI: a flat grid at z = 0.5 m (a pixel is 1/1024 m, exact in
    fp32) of spacing 1-16 px with vertices on pixel centres or half-way, so
    edges run through pixel centres and across the kernel's tile borders and
    neighbouring faces tie exactly in depth; a slanted grid that crosses it;
    and three large faces across tile borders behind both."""
    flat = lambda u: np.full_like(u, 0.5)                               # noqa: E731
    slant = lambda u: 0.5 + 0.004 * (u - 32.0) / 64.0                  # noqa: E731
    big_uv = np.array([[15.5, -3], [16, 70], [47.5, 31.5], [0, 16], [64, 16.5], [31, 47.9],
                       [-5, -5], [70, 31.5], [31.5, 70]])
    big = np.concatenate([big_uv * (0.55 / 512.0), np.full((9, 1), 0.55)], 1)
    meshes = []
    for i, (sp, off) in enumerate(((1, 0.0), (2, 0.0), (3, 0.5), (4, 0.0), (5, 0.5),
                                   (8, 0.0), (16, 0.0), (6, 0.5))[:n]):
        p1, f1 = _seam_grid(sp, off, i % 2 == 1, flat)
        p2, f2 = _seam_grid(4 + i % 3, 0.25 * i, i % 2 == 0, slant)
        pts = np.concatenate([p1, p2, big])
        faces = np.concatenate([f1, f2 + len(p1),
                                np.arange(9).reshape(3, 3) + len(p1) + len(p2)])
        meshes.append((pts, faces))
    V = max(len(p) for p, _ in meshes)
    F = max(len(f) for _, f in meshes)
    verts = np.zeros((n, V, 3), np.float32)
    faces = np.zeros((n, F, 3), np.int32)          # (0, 0, 0) padding
    for i, (p, f) in enumerate(meshes):
        verts[i, :len(p)], faces[i, :len(f)] = p, f
    dev = lambda a: torch.as_tensor(a, device=device)                 # noqa: E731
    K = np.tile(np.diag([512.0, 512.0, 1.0]).astype(np.float32), (n, 1, 1))
    return (dev(verts), dev(faces), dev(np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))),
            dev(np.zeros((n, 3), np.float32)), dev(K), 64, 64)


def _raster_case(label, verts, faces, R, t, K, H, W):
    """The pack kernel vs the torch packing and the cull rule, and the
    kernel (both modes) vs plain (both modes), at one shape; returns the
    worst depth / xyz errors."""
    from gdrnpp_bop2022_torch.ops.raster import (_pack_face_data, face_major,
                                                 face_screen_boxes, pack_faces_cuda,
                                                 render_depth_xyz_cuda, transform_verts)
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
    for attrs in (True, False):
        packed, boxes = pack_faces_cuda(verts, faces, R, t, K, H, W, with_attrs=attrs)
        fd = _pack_face_data(transform_verts(verts, R, t), verts, faces, K, with_attrs=attrs)
        check(torch.equal(packed, face_major(fd)),
              f"B2 {label}: the pack kernel differs from the torch packing")
        check(torch.equal(boxes, face_screen_boxes(fd, H, W)),
              f"B2 {label}: the pack kernel's boxes differ from face_screen_boxes")
    d, x = render_depth_xyz_cuda(verts, faces, R, t, K, H, W)
    d_only, _ = render_depth_xyz_cuda(verts, faces, R, t, K, H, W, need_xyz=False)
    d_ref, x_ref = render_depth_xyz_batch(verts, faces, R, t, K, H, W,
                                          max_block=PLAIN_MAX_BLOCK)
    d_ref_only, _ = render_depth_xyz_batch(verts, faces, R, t, K, H, W, need_xyz=False,
                                           max_block=PLAIN_MAX_BLOCK)
    torch.cuda.synchronize()
    hit = d_ref > 0
    check(bool(hit.any()), f"B2 {label}: nothing rendered")
    check(torch.equal(d > 0, hit) and torch.equal(d_only > 0, hit),
          f"B2 {label}: silhouettes differ from the plain version")
    check(torch.equal(d_only, d), f"B2 {label}: depth-only depth != attribute-mode depth")
    check(torch.equal(d_ref_only, d_ref), f"B2 {label}: plain depth-only != plain full")
    d_err = float((d - d_ref)[hit].abs().max())
    x_err = float((x - x_ref)[hit].abs().max())
    check(d_err <= RASTER_DEPTH_TOL and x_err <= RASTER_XYZ_TOL,
          f"B2 {label}: depth err {d_err}, xyz err {x_err}")
    check(bool((d[~hit] == 0).all() and (x[~hit] == 0).all()), f"B2 {label}: misses not 0")
    exact = torch.equal(d, d_ref) and torch.equal(x, x_ref)
    log(f"[3/7] B2 {label}: packed faces and boxes == torch packing and face_screen_boxes "
        f"bit for bit; silhouettes identical ({int(hit.sum())} px hit), depth-only == "
        f"attribute depth bit for bit; max abs err depth {d_err:.3g} m, xyz {x_err:.3g} m "
        f"({'bit-equal' if exact else 'not bit-equal'} to the plain version)")
    return max(d_err, x_err)


def cull_stats(boxes, H, W):
    """Faces left per RASTER_TILE tile after culling (B, tiles), and the
    pixel-face pairs whose pixel centre lies in the face's box."""
    tw, th = RASTER_TILE
    ty0, tx0 = (a.reshape(-1) for a in torch.meshgrid(
        torch.arange(0, H, th, device=boxes.device),
        torch.arange(0, W, tw, device=boxes.device), indexing="ij"))
    tx1 = (tx0 + tw).clamp(max=W) - 1
    ty1 = (ty0 + th).clamp(max=H) - 1
    b = boxes.long()
    per_tile = torch.zeros(b.shape[0], len(tx0), dtype=torch.long, device=b.device)
    for i in range(b.shape[0]):       # one ROI at a time: (F, tiles) stays small
        bi = b[i][:, None]
        per_tile[i] = ((bi[..., 0] <= tx1) & (bi[..., 2] >= tx0) & (bi[..., 1] <= ty1)
                       & (bi[..., 3] >= ty0)).sum(0)
    pairs = ((b[..., 2] - b[..., 0] + 1).clamp(min=0)
             * (b[..., 3] - b[..., 1] + 1).clamp(min=0)).sum()
    return per_tile, float(pairs)


def raster_bound(verts, faces, R, t, K, H, W):
    """Least time of one depth-only call on this input: the fp32 ops of the
    tests it needs (the pixel-face pairs inside the valid faces' screen
    boxes) vs the bytes read and written; and the all-pairs figure (every
    valid face at every pixel: the TPU kernel's work, and the first CUDA
    version's)."""
    from gdrnpp_bop2022_torch.ops.raster import (_pack_face_data, face_screen_boxes,
                                                 transform_verts)
    fd = _pack_face_data(transform_verts(verts, R, t), verts, faces, K, with_attrs=False)
    per_tile, pairs = cull_stats(face_screen_boxes(fd, H, W), H, W)
    all_pairs = float(fd[:, 9].sum()) * H * W
    n_bytes = sum(a.numel() * a.element_size() for a in (verts, faces, R, t, K)) \
        + verts.shape[0] * H * W * 4
    bytes_s = n_bytes / H100_BYTES_PER_S
    ops_s = pairs * RASTER_OPS_PER_TEST / H100_FP32_FLOPS
    all_s = all_pairs * RASTER_OPS_PER_TEST / H100_FP32_FLOPS
    return {"bound_ms": max(ops_s, bytes_s) * 1e3,
            "bound_by": "operations" if ops_s >= bytes_s else "bytes", "pairs": pairs,
            "all_pairs": all_pairs, "all_pairs_bound_ms": max(all_s, bytes_s) * 1e3,
            "per_tile": per_tile}


def b2_times(flag):
    """B2 depth-only at `flag` through `render_depth_xyz_cuda` (what every
    version has): hot and cold ms per call, and the device ms per call in
    the raster kernel and in the pack kernel (torch.profiler)."""
    from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda
    call = lambda: render_depth_xyz_cuda(*flag, need_xyz=False)     # noqa: E731
    k = kernel_ms(call, ("raster_kernel", "pack_faces_kernel"))
    return {"ms": cuda_ms(call), "cold_ms": cold_ms(call), "kernel_ms": k["raster_kernel"],
            "pack_kernel_ms": k["pack_faces_kernel"]}


def flagship_raster_input(scene, bank):
    """The depth-refine batch of phase 3: 64 ROIs, 64x64 crop-K, 4096 faces."""
    from gdrnpp_bop2022_torch.geometry.camera import centered_crop_K
    rb = refine_batch(scene, bank, np.random.RandomState(SEED + 3))
    cK = centered_crop_K(rb["K"], rb["centers"], rb["scales"], 64)
    return rb, (rb["verts"], rb["faces"], rb["R"], rb["t"], cK, 64, 64)


def phase_raster(card, scene, bank):
    from gdrnpp_bop2022_torch.ops.raster import (_kernels, pack_faces_cuda,
                                                 render_depth_xyz_cuda)
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
    worst = 0.0
    rb, flag = flagship_raster_input(scene, bank)
    F = flag[1].shape[1]
    worst = max(worst, _raster_case(f"flagship B={BATCH} 64x64 F={F}", *flag))
    # ragged: 54x72 (not a multiple of the 32x8 tile)
    K2 = flag[4][:4].clone()
    K2[:, 0, 2] -= 5.0
    K2[:, 1, 2] -= 3.0
    worst = max(worst, _raster_case("ragged B=4 54x72", rb["verts"][:4], rb["faces"][:4],
                                    rb["R"][:4], rb["t"][:4], K2, 54, 72))
    # full image: 2 ROIs at 480x640 with the camera's own K (what VSD renders)
    K = torch.as_tensor(scene["K"], dtype=torch.float32, device="cuda")[None].expand(2, 3, 3)
    t2 = torch.tensor([[0.03, -0.02, 0.45], [-0.05, 0.04, 0.6]], device="cuda")
    full = (rb["verts"][:2], rb["faces"][:2], rb["R"][:2], t2, K.contiguous(), 480, 640)
    worst = max(worst, _raster_case("full image B=2 480x640", *full))
    worst = max(worst, _raster_case("seam scene B=8 64x64", *seam_scene()))

    # faces per tile after culling, and the bound, at the flagship
    bd = raster_bound(*flag)
    pt = bd["per_tile"].float()
    log(f"[3/7] B2 flagship culling: faces per {RASTER_TILE[0]}x{RASTER_TILE[1]} tile mean "
        f"{float(pt.mean()):.1f}, max {int(pt.max())} of {F}; {bd['pairs']:.4e} pixel-face "
        f"pairs inside the boxes vs {bd['all_pairs']:.4e} all pairs")
    # times at the flagship, depth only (the mode depth refinement runs)
    t = b2_times(flag)
    k_attr_ms = cuda_ms(lambda: render_depth_xyz_cuda(*flag))
    full_ms = device_ms(lambda: render_depth_xyz_cuda(*full, need_xyz=False))
    # the raster kernel alone on packed faces (a direct call: no launch is counted)
    packed, boxes = pack_faces_cuda(*flag, with_attrs=False)
    out = torch.empty((BATCH, 64, 64), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: _kernels().gdrn_raster_fwd(packed.data_ptr(), boxes.data_ptr(),  # noqa: E731
                                                BATCH, F, 64, 64, out.data_ptr(), None, 0,
                                                stream)
    check(launch() == 0, "B2 direct launch failed")
    kernel_only_ms = cuda_ms(launch)
    check(torch.equal(out, render_depth_xyz_cuda(*flag, need_xyz=False)[0]),
          "B2 direct launch differs from the wrapper")
    p_ms = cuda_ms(lambda: render_depth_xyz_batch(*flag, need_xyz=False,
                                                  max_block=PLAIN_MAX_BLOCK), iters=3,
                   warmup=1)
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"          # noqa: E731
    log(f"[3/7] B2 flagship depth only: wrapper hot {t['ms']:.4f} ms, cold "
        f"{t['cold_ms']:.4f} ms (2 launches; the raster kernel alone {kernel_only_ms:.4f} ms "
        f"by events, {fmt(t['kernel_ms'])} by the profiler, the pack kernel "
        f"{fmt(t['pack_kernel_ms'])}); attribute mode {k_attr_ms:.4f} ms; plain "
        f"{p_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms ({bd['pairs']:.4e} tests x "
        f"{RASTER_OPS_PER_TEST} fp32 ops at 67 TFLOP/s, {bd['bound_by']}), all-pairs bound "
        f"{bd['all_pairs_bound_ms']:.4f} ms  [{card}]")
    log(f"[3/7] B2 full image depth only (2 ROIs at 480x640, {F} faces): pack + raster "
        f"kernels {full_ms:.4f} ms of device time per call  [{card}]")
    return {"max_abs_err": worst, "ms": t["ms"], "cold_ms": t["cold_ms"], "plain_ms": p_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "all_pairs_bound_ms": bd["all_pairs_bound_ms"], "library_ms": None,
            "kernel_ms": kernel_only_ms}


# ---------------------------------------------------------------------------
# the served paths
# ---------------------------------------------------------------------------

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


def _check_rows(results, n_rois, tmp, tag):
    from gdrnpp_bop2022_torch.bop.inout import load_bop_results, save_bop_results
    from gdrnpp_bop2022_torch.engine.inference import results_to_bop_rows
    check(len(results) == n_rois, f"{tag}: {len(results)} rows for {n_rois} detections")
    R = np.stack([r["R"] for r in results])
    t = np.stack([r["t"] for r in results])
    check(np.isfinite(R).all() and np.isfinite(t).all(), f"{tag}: non-finite pose")
    orth = float(np.abs(np.swapaxes(R, 1, 2) @ R - np.eye(3)).max())
    check(orth < 1e-3, f"{tag}: |R^T R - I| = {orth}")
    csv = os.path.join(tmp, f"poses_{tag}.csv")
    save_bop_results(csv, results_to_bop_rows(results))
    check(len(load_bop_results(csv)) == n_rois, f"{tag}: CSV row count")
    return orth


def phase_slice(card, tmp):
    from gdrnpp_bop2022_torch.config import Config
    from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split,
                                                        load_detections,
                                                        make_records_by_image)
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    from gdrnpp_bop2022_torch.engine.inference import run_gdrn_inference
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    cfg = Config()
    pc = cfg.model.pose_net
    check(pc.backbone.name == "convnext_base" and pc.num_classes == 21
          and pc.input_res == 256 and pc.output_res == 64
          and cfg.model.compute_dtype == "bfloat16", "Config() is not the flagship")
    model = build_gdrn(cfg)
    check(next(model.parameters()).is_cuda, "build_gdrn did not build on the card")
    model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    meta, split_dir, det_file = _write_scene(tmp, np.random.RandomState(SEED))
    by_im = make_records_by_image(index_bop_split(split_dir, meta))
    dets = load_detections(det_file, meta, top_k_per_obj=1)
    batches = iter_test_batches(by_im, dets, batch_size=BATCH)
    extents = np.random.RandomState(SEED + 1).uniform(0.05, 0.25, (21, 3))

    stats = {}
    layer_norm.launches = 0                       # count this path only
    results = run_gdrn_inference(model, batches, extents,
                                 input_res=pc.input_res, output_res=pc.output_res,
                                 pixel_mean=cfg.model.pixel_mean,
                                 pixel_std=cfg.model.pixel_std,
                                 post_mode="direct", stats=stats)
    launches = layer_norm.launches
    n_rois = N_IMAGES * DETS_PER_IMAGE
    check(forwards[0] == stats["n_batches"] + 1, f"{forwards[0]} forwards for "
          f"{stats['n_batches']} batches + warm-up")
    check(launches == LN_PER_FORWARD * forwards[0],
          f"layer_norm launches {launches} != 40 x {forwards[0]} forwards")
    orth = _check_rows(results, n_rois, tmp, "rgb")
    log(f"[4/7] RGB: served {n_rois} ROIs ({N_IMAGES} images) in {stats['n_batches']} "
        f"batches of {BATCH} + warm-up: {forwards[0]} forwards, layer_norm "
        f"launches {launches} = 40 x {forwards[0]}; rows finite, "
        f"max|R^T R - I| = {orth:.2e}; CSV {len(results)} rows")
    log(f"[4/7] RGB serving (ROI crop + forward + decode, host clock after "
        f"synchronize): {stats['rois_per_sec']:.1f} ROI/s, p50 "
        f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms per batch of "
        f"{BATCH}  [{card}]")

    # the model alone at batch 64, device time by CUDA events
    b0 = next(iter_test_batches(by_im, dets, batch_size=BATCH))
    from gdrnpp_bop2022_torch.engine.batching import build_test_batch
    dev = lambda a: torch.as_tensor(a).cuda()    # noqa: E731
    with torch.inference_mode():
        rb = build_test_batch(dev(b0["images"]), dev(b0["img_idx"]),
                              dev(b0["boxes_xyxy"]), dev(b0["Ks"]),
                              dev(b0["labels"]), dev(extents).float(),
                              input_res=pc.input_res, output_res=pc.output_res)
        fwd_ms = cuda_ms(lambda: model(**rb), iters=10)
    log(f"[4/7] GDRN forward alone at batch {BATCH}, bf16: {fwd_ms:.3f} ms = "
        f"{BATCH / fwd_ms * 1e3:.1f} ROI/s  [{card}]")
    return rb


def phase_rgbd_slice(card, scene, bank, tmp):
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd
    from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split,
                                                        load_detections,
                                                        make_records_by_image)
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    from gdrnpp_bop2022_torch.engine.batching import build_depth_rois, build_test_batch
    from gdrnpp_bop2022_torch.engine.inference import (decode_dense_outputs,
                                                       run_gdrn_inference)
    from gdrnpp_bop2022_torch.eval.pnp_eval import depth_refine_batch
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.crop import roi_crop_resize
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.ops.raster import pack_faces_cuda, render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    cfg = ycbv_convnext_base_rgbd()
    pc = cfg.model.pose_net
    check(pc.name == "gdrn_dstream_double_mask" and pc.fuse_type == "cat"
          and pc.backbone.name == "convnext_base" and pc.num_classes == 21
          and cfg.model.compute_dtype == "bfloat16" and cfg.val.use_depth_refine,
          "the RGB-D config is not the BOP'22 recipe")
    iters = cfg.val.depth_refine_iters
    model = build_gdrn(cfg)
    check(model.depth_backbone is not None and next(model.parameters()).is_cuda,
          "the RGB-D model has no depth stream on the card")
    model.load_state_dict(seeded_state_dict(model, SEED + 5), strict=True)
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))

    meta = scene["meta"]
    by_im = make_records_by_image(index_bop_split(scene["split_dir"], meta))
    dets = load_detections(scene["det_file"], meta, top_k_per_obj=1)
    mk = lambda: iter_test_batches(by_im, dets, batch_size=BATCH, with_depth=True,  # noqa: E731
                                   depth_factor=meta.depth_factor)
    kw = dict(input_res=pc.input_res, output_res=pc.output_res,
              pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
              post_mode="depth_refine", model_bank=bank, depth_refine_iters=iters,
              depth_refine_threshold=cfg.val.depth_refine_threshold,
              mask_loss_type=pc.loss.mask_loss_type, with_depth_input=cfg.input.with_depth,
              bp_depth=cfg.input.bp_depth, coord_2d_type=pc.pnp_net.coord_2d_type)
    stats = {}
    layer_norm.launches = 0                       # count this path only
    render_depth_xyz_cuda.launches = pack_faces_cuda.launches = 0
    results = run_gdrn_inference(model, mk(), bank.extents, stats=stats, **kw)
    ln_launches, r_launches = layer_norm.launches, render_depth_xyz_cuda.launches
    p_launches = pack_faces_cuda.launches
    n_rois = N_IMAGES * DETS_PER_IMAGE
    nb = stats["n_batches"]
    check(forwards[0] == nb + 1, f"RGB-D: {forwards[0]} forwards for {nb} batches + warm-up")
    check(ln_launches == 2 * LN_PER_FORWARD * forwards[0],
          f"RGB-D: layer_norm launches {ln_launches} != 80 x {forwards[0]} forwards")
    check(r_launches == iters * (nb + 1),
          f"RGB-D: raster launches {r_launches} != {iters} x ({nb} batches + warm-up)")
    check(p_launches == r_launches, f"RGB-D: pack launches {p_launches} != raster "
          f"launches {r_launches}")
    orth = _check_rows(results, n_rois, tmp, "rgbd")
    log(f"[5/7] RGB-D: served {n_rois} ROIs ({N_IMAGES} images, depth PNGs, bank of "
        f"{bank.faces.shape[0]} meshes x {bank.faces.shape[1]} faces) in {nb} batches of "
        f"{BATCH} + warm-up, post_mode=depth_refine x{iters}: {forwards[0]} forwards, "
        f"layer_norm launches {ln_launches} = 80 x {forwards[0]}, raster launches "
        f"{r_launches} = {iters} x {nb + 1} (and as many pack launches); rows finite, max|R^T R - I| = {orth:.2e}; "
        f"CSV {len(results)} rows")
    log(f"[5/7] RGB-D serving (ROI + depth crops + forward + depth refine, host clock "
        f"after synchronize): {stats['rois_per_sec']:.1f} ROI/s, p50 "
        f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms per batch of "
        f"{BATCH}  [{card}]")

    # the layers alone at batch 64, device time by CUDA events
    b0 = next(mk())
    dev = lambda a: torch.as_tensor(a).cuda()    # noqa: E731
    with torch.inference_mode():
        img_idx, Ks = dev(b0["img_idx"]), dev(b0["Ks"])
        rb = build_test_batch(dev(b0["images"]), img_idx, dev(b0["boxes_xyxy"]), Ks,
                              dev(b0["labels"]), dev(bank.extents).float(),
                              input_res=pc.input_res, output_res=pc.output_res)
        depths = dev(b0["depths"])
        scales = pc.output_res / rb["resize_ratios"]
        rb["roi_depth"] = build_depth_rois(depths, img_idx, rb["roi_centers"], scales,
                                           Ks, input_res=pc.input_res)
        fwd_ms = cuda_ms(lambda: model(**rb), iters=10)
        out = model(**rb)
        xyz, mask = decode_dense_outputs(out, pc.loss.mask_loss_type)
        d_crop = roi_crop_resize(depths[..., None], rb["roi_centers"], scales,
                                 pc.output_res, method="nearest", img_idx=img_idx)[..., 0]
        lab = rb["roi_labels"]
        bv = torch.as_tensor(bank.verts, device="cuda")[lab]
        bf = torch.as_tensor(bank.faces, device="cuda")[lab]
        ref_args = (out["rot"], out["trans"], mask, xyz, d_crop, Ks, rb["roi_centers"],
                    scales, bv, bf, rb["roi_extents"])
        refine_ms = cuda_ms(lambda: depth_refine_batch(*ref_args, iters=iters,
                                                       out_res=pc.output_res), iters=10)
    log(f"[5/7] RGB-D forward alone at batch {BATCH}, bf16: {fwd_ms:.3f} ms = "
        f"{BATCH / fwd_ms * 1e3:.1f} ROI/s; depth refine x{iters}: {refine_ms:.3f} ms "
        f"per batch  [{card}]")
    rows2 = {k: v[:2] for k, v in rb.items()}
    return ln_launches, r_launches, rows2, {"fwd_ms": fwd_ms, "refine_ms": refine_ms,
                                            "p50_ms": stats["p50_ms"]}


def phase_refine(card, scene, bank):
    """Depth refinement from GT R and GT t + 4 cm in z, through B2 and
    through the plain rasterizer."""
    from gdrnpp_bop2022_torch.eval.pnp_eval import depth_refine_batch
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
    rb = refine_batch(scene, bank, np.random.RandomState(SEED + 7))
    t_bad = rb["t"] + torch.tensor([0.0, 0.0, REFINE_OFFSET_M], device="cuda")
    args = (rb["R"], t_bad, rb["mask"], rb["xyz"], rb["depth"], rb["K"], rb["centers"],
            rb["scales"], rb["verts"], rb["faces"], rb["extents"])
    with torch.inference_mode():
        t_k = depth_refine_batch(*args, iters=2, out_res=rb["out_res"])
        t_p = depth_refine_batch(*args, iters=2, out_res=rb["out_res"],
                                 render=render_depth_xyz_batch)
    torch.cuda.synchronize()
    z_err = (t_k[:, 2] - rb["t"][:, 2]).abs()
    worst_z = float(z_err.max())
    check(worst_z < 0.3 * REFINE_OFFSET_M,
          f"depth refine left a z error of {worst_z} m from a {REFINE_OFFSET_M} m offset")
    dt = float((t_k - t_p).abs().max())
    check(dt <= REFINE_T_TOL, f"refined t, B2 vs plain rasterizer: {dt} m")
    log(f"[6/7] depth refine at batch {BATCH} from GT t + {REFINE_OFFSET_M * 100:.0f} cm "
        f"in z, 2 iterations: z error max {worst_z * 1e3:.3f} mm, mean "
        f"{float(z_err.mean()) * 1e3:.3f} mm (limit {0.3 * REFINE_OFFSET_M * 1e3:.1f} mm); "
        f"B2 vs plain rasterizer max |dt| = {dt:.3g} m  [{card}]")


def _parity(cfg, batch, tag):
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
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
              f"{tag} card vs CPU {k}: max abs diff {d} > {tol}")
    log(f"[7/7] fp32 {tag}, 2 ROIs, card (B1 kernel) vs CPU (plain), TF32 "
        "off: max abs diff " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))


def phase_parity(rb, rb_rgbd):
    """The flagship RGB and RGB-D models in fp32 on the card (kernels) and on
    the CPU (plain path)."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = {"model.compute_dtype": "float32"}
    for cfg, batch, tag in ((replace_cfg(Config(), f32), rb, "RGB flagship"),
                            (replace_cfg(ycbv_convnext_base_rgbd(), f32), rb_rgbd,
                             "RGB-D flagship")):
        _parity(cfg, {k: v[:2].float() if v.is_floating_point() else v[:2]
                      for k, v in batch.items()}, tag)


def timing_only(root):
    """B1's and B2's times at the flagship shapes for the package under
    `root`, through the wrappers every version has; the last line is JSON."""
    sys.path.insert(0, os.path.abspath(root))
    import gdrnpp_bop2022_torch
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    pkg = os.path.dirname(os.path.abspath(gdrnpp_bop2022_torch.__file__))
    log(f"timing {pkg}")
    _, card = phase_device()
    ln = ln_times(card)
    with tempfile.TemporaryDirectory() as tmp:
        # phase 3's flagship: the scene's first draw is the models' axes
        axes_mm = np.random.RandomState(SEED + 2).uniform(25.0, 100.0, (21, 3))
        write_models(os.path.join(tmp, "models"), axes_mm)
        bank = ModelBank.from_bop_models_dir(os.path.join(tmp, "models"))
    scene = {"K": get_meta("ycbv").camera_matrix.astype(np.float64), "axes_mm": axes_mm}
    b2 = b2_times(flagship_raster_input(scene, bank)[1])
    log(f"B2 flagship depth only: wrapper hot {b2['ms']:.4f} ms, cold {b2['cold_ms']:.4f} ms,"
        f" raster kernel {b2['kernel_ms']} ms, pack kernel {b2['pack_kernel_ms']} ms "
        f"(profiler)  [{card}]")
    print(json.dumps({"package": pkg, "card": card,
                      "b1": {k: ln[k] for k in ("ms", "cold_ms", "library_ms",
                                                 "library_cold_ms", "copy_cold_ms",
                                                 "bound_ms")},
                      "b2": b2}))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a card",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--timing-only"]:
        return timing_only(sys.argv[2])
    import gdrnpp_bop2022_torch  # noqa: F401  (fails here outside a checkout)
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    torch.manual_seed(SEED)
    t_start = time.perf_counter()
    name, card = phase_device()
    ln = phase_kernels(card)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        scene = make_rgbd_scene(os.path.join(tmp, "rgbd"), np.random.RandomState(SEED + 2))
        bank = ModelBank.from_bop_models_dir(scene["models_dir"])
        check(bank.faces.shape == (21, 4096, 3), f"bank faces {bank.faces.shape}")
        log(f"[3/7] RGB-D scene and model bank written and loaded in "
            f"{time.perf_counter() - t0:.1f} s (analytic depth, no rendering)")
        b2 = phase_raster(card, scene, bank)
        rb = phase_slice(card, os.path.join(tmp, "rgb"))
        ln_launches, r_launches, rb_rgbd, times = phase_rgbd_slice(card, scene, bank, tmp)
        phase_refine(card, scene, bank)
    share = 100.0 * 2 * b2["ms"] / times["p50_ms"]
    log(f"[5/7] B2 share of an RGB-D batch: 2 calls x {b2['ms']:.4f} ms of a "
        f"{times['p50_ms']:.2f} ms p50 batch = {share:.2f}%  [{card}]")
    phase_parity(rb, rb_rgbd)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "gdrnpp_bop2022_tpu"))
    check(not bad, f"the port imported {bad[:3]}")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "layer_norm", "route": "cuda",
         "source": "gdrnpp_bop2022_torch/csrc/layer_norm.cu",
         "replaces": "gdrnpp_bop2022_tpu/ops/pallas_ln.py:26",
         "launches": ln_launches, "max_abs_err": ln["max_abs_err"], "ms": ln["ms"],
         "cold_ms": ln["cold_ms"], "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": ln["bound_by"], "library_ms": ln["library_ms"]},
        {"name": "render_depth_xyz", "route": "cuda",
         "source": "gdrnpp_bop2022_torch/csrc/raster.cu",
         "replaces": "gdrnpp_bop2022_tpu/ops/pallas_raster.py:53",
         "launches": r_launches, "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "cold_ms": b2["cold_ms"], "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
         "bound_by": b2["bound_by"], "all_pairs_bound_ms": b2["all_pairs_bound_ms"],
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
