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

then the evaluation path: the three PnP post modes on the RGB path, and the
BOP scorer (VSD through B2 at image size, the port's ``score_csv`` CLI) on
the RGB-D scene; then GDRN training of both BOP'22 recipes as configured
(``configs.ycbv_convnext_base()`` and ``configs.ycbv_convnext_base_rgbd()``
through ``engine.trainer.train_gdrn`` on a synthetic BOP train split, with
colour, background and depth augmentation, and in pool mode); then the YOLOX
detector at the BOP'22 recipe and the two-stage path (images -> detections
-> handoff json -> poses -> scores); then the GDRN model variants (other
backbones, heads and PnP nets) at full width; then the BOP sweep over two
datasets, the per-object path and the release tools; then the exported
forward and the auxiliary ops; and checks the models on the card against
the same models on the CPU in fp32. It prints its wall time. Phases:

  1. device: name, versions, power limit; build both kernels (one nvcc
     each, started together); registers and spills of every instantiation of
     B1's backward as ptxas built them (-Xptxas -v; a spill fails);
  2. B1 (LayerNorm) vs plain at the shapes the main paths give it, on both
     of its paths (16-byte vectors; one element per access for C = 100 and
     an input offset by one element), with hot (device time of back-to-back
     calls) and cold (L2 flushed before each call) times;
  3. B2 (rasterizer) vs plain, both modes: the flagship depth-refine batch
     (64 ROIs, 64x64, 4096-face meshes), a ragged 54x72 case, 2 ROIs at
     480x640 and an adversarial seam scene (edges through pixel centres,
     faces across tile borders); the pack kernel's output against the torch
     packing and the cull rule bit for bit; faces per tile after culling;
     depth-only at the scorer's VSD shapes (image-grid windows with a
     shifted principal point, 128^2 x 256, 256^2 x 64 and 480x512 x 17,
     and the full 480x640 image x 16) with their times, bounds and the
     time of the box tests alone;
  4. the RGB slice: PNGs + detections on disk -> index_bop_split ->
     load_detections -> iter_test_batches -> run_gdrn_inference ->
     results_to_bop_rows -> save_bop_results, with launch counts;
  5. the RGB-D slice: the same with depth PNGs, the model bank from PLY
     files, the dual-stream model and depth refinement, with launch counts;
  6. depth refinement at batch 64 from GT R and GT t + 4 cm in z, through
     B2 and through the plain rasterizer;
  7. PnP: the three ``pose_from_dense_*`` recover 64 known poses from the
     XYZ, mask and 2D coords that B2's attribute mode renders (what a
     perfect network would give), within 1 degree and 1 cm; the RGB
     flagship serves 192 ROIs with each PnP ``post_mode``, with launch
     counts and times per batch;
  8. scoring: ``score_bop_results(device="cuda", vsd_mode="full")`` on the
     RGB-D scene's 192 GT instances: GT poses as estimates score AR = 1
     exactly; a ladder of perturbed estimates scores below 1, the same
     through B2 and through the plain rasterizer, and within 1e-3 of the
     port on the CPU on one image; bbox VSD equals full-image VSD for every
     pair whose plan fits a bucket; the RGB-D CSV through
     ``python -m gdrnpp_bop2022_torch.tools.score_csv``;
  9. card vs CPU parity of the RGB and the RGB-D flagship in fp32 (run
     last, after phase 13);
 10. training: B1's backward kernel vs its plain version (autograd through
     layer_norm_ref) at the four ConvNeXt-base shapes at batch 48, at its
     tiles' edges (1 and 3 rows, a ragged last tile), with mean and rstd as
     views at an odd row and 4 rows in, and on the scalar path, 20 calls in a
     row bit-equal; per width and per step, hot / cold times and the share of
     the bound, its two kernels apart, beside the plain version, aten's
     native_layer_norm_backward and a copy_ of the same bytes; a
     synthetic train split (RGB, analytic depth, mask/ and mask_visib/ PNGs
     from the analytic hits, scene_gt*.json), TRAIN_BG_IMAGES backgrounds,
     and the bank decimated to 1024 faces with 64 FPS keypoints; B2's
     attribute mode at a training batch vs plain; background replacement and
     cosy+aae colour augmentation on the card vs their plain versions on the
     CPU given the same draws; the flagship recipe as configured (colour
     augmentation at 0.8, backgrounds at 0.5) with a short warmup for
     TRAIN_STEPS steps at batch 48 through ``train_gdrn``: step time p50 /
     p99 by CUDA events split into H2D / augmentations / online batch /
     forward + backward / optimizer + EMA, the host wait on the loader,
     ROIs/s, peak memory, launches per step (B1 40 + 40 and 40 reductions,
     B2 1 + 1), a falling loss (every trainable term, on a batch held apart)
     and EMA != params; the checkpoint restored on the card bit for bit; one
     fp32 step of the tiny config on the card and on the CPU; pool mode
     (``train.device_pool_frames``): batches from frames kept on the card
     equal the host batches of the same seed and draws, then a few steps
     and the pools' stats;
 11. RGB-D training: ``configs.ycbv_convnext_base_rgbd()`` (two
     convnext_base, concat fusion, depth augmentation) at batch 48 for
     TRAIN_RGBD_STEPS steps: B1's backward at its shapes vs plain, launches
     per step (B1 80 + 80 and 80 reductions, B2 1 + 1), the split (online
     batch / depth aug + depth ROIs / forward + backward / optimizer + EMA),
     peak memory, the trainable-loss criterion, EMA != params, the
     checkpoint bit for bit, the busy share of three profiled steps, and one
     tiny dual-stream fp32 step card vs CPU;
 12. the detector: the BOP'22 recipe ``configs.yolox("ycbv")`` (yolox-x at
     640x640, 21 classes, bf16), GN and BN (BN with drawn running
     statistics), at batch 8 on the RGB-D scene's 24 letterboxed images:
     forward, plain detection and TTA (5 scales x flip, one joint NMS) times
     by CUDA events with images/s, the NMS's ms and share of a batch,
     kernels and copies a batch, peak memory; the card's NMS equal to a
     numpy greedy NMS on the same raw rows (plain and TTA); the card against
     the CPU in fp32 on 2 images; GT boxes scored as detections by
     ``coco_map`` (100/101, its ceiling);
 13. two-stage: ``python -m gdrnpp_bop2022_torch.tools.test_yolox --config
     ycbv`` (TTA) on the scene -> the handoff json -> ``test_gdrn`` with
     ``model.load_dets_test=True`` (B1's launches counted, ROI/s) -> its CSV
     through ``python -m gdrnpp_bop2022_torch.tools.score_csv``; then
     ``python -m gdrnpp_bop2022_torch.tools.demo_gdrn`` with yolox-x inline
     on 4 images;
 14. detector training: the batch of the recipe ``configs.yolox("ycbv")``
     (yolox-x, GN, Ranger, EMA, mosaic + mixup + HSV + flip, multiscale
     (14, 26) x 32) chosen by one step's peak memory at 832 x 832 (32, else
     16, else 8), then the recipe through ``engine.yolox_trainer.
     train_yolox`` on 16 of the scene's 24 images as DetRecords (warmup and
     length cut, the no-aug switch for the last iterations): step p50 / p99 and
     images/s by CUDA events split into H2D / multiscale resize / forward +
     loss + backward / optimizer + EMA, simOTA alone, the host's wait on the
     loader, peak memory, kernels and copies a step and the busy share of
     three profiled steps; on a batch of the 8 images held apart each of
     the IoU, objectness and class losses at the EMA weights below 0.8x its
     value at the initial weights, EMA != params, the
     checkpoint restored bit for bit; the BN variant's running statistics
     against a float64 recomputation of the biased update; one fp32 BN step
     card vs CPU and simOTA card vs CPU; yolox_s learns a two-class split to
     AP50 >= 0.5; ``python -m gdrnpp_bop2022_torch.tools.test_yolox --ckpt``
     serves the trained EMA weights and writes the handoff json;
 15. the GDRN variants at the flagship's width (21 classes, bf16, batch 64,
     256^2 input), seeded weights, each served through
     ``run_gdrn_inference(post_mode="direct")`` on phase 4's RGB scene (V6:
     the RGB-D scene): V1 resnet34 + single mask (GDR-Net's layout), V2
     resnest50 + cls2reg over 64 bins + ConvPnPNetCls, V3 convnext_base +
     the FPN head + SimplePointPnPNet (B1: 40 a forward), V4 resnet18_8s +
     the conv-only head with ACON + ConvPnPNet with LN (output 32^2), V5
     cspdarknet + ConvPnPNet without norm, V6 two convnext_base fused by
     ConvFuseNet (B1: 80 a forward): rows finite and orthonormal, the CSV,
     forwards and B1 launches counted, serving ROI/s with p50 / p99 a batch,
     the forward alone by CUDA events, and each against the CPU in fp32 on 2
     ROIs with TF32 off;
 16. the BOP sweep: a second scene for lmo (its 8 object ids and camera,
     analytic depth), then ``python -m gdrnpp_bop2022_torch.tools.
     run_bop_sweep --datasets ycbv lmo --mode eval`` with yolox-x at 640^2
     (random weights) and the convnext_base recipes at full width (seed 0):
     per dataset ``test_yolox`` writes the handoff json and ``test_gdrn``
     serves and scores it, each in a process of its own (B1's launches per
     GDRN forward and B2's in the scorer read from the stage's stats.json);
     the summary's mean_AR; ``score_csv --dataset lmo`` on the lmo scene's
     GT poses as estimates (AR = AR_vsd = AR_mssd = AR_mspd = 1.0); then the
     per-object path: ``test_gdrn --config
     ycbvSO/<obj>`` for two objects, ``merge_so_results``,
     ``process_results_time`` (one time per image), ``score_csv`` on the
     merged CSV; ``strip_ckpt --use-ema`` on phase 10's checkpoint, whose
     weights serve the poses the checkpoint serves;
 17. ``python -m gdrnpp_bop2022_torch.tools.export_model`` of the flagship
     ``Config()`` at batch 64 with seeded weights (``torch.export``; B1 is
     the operator ``gdrnpp::layer_norm``), reloaded and run: 40 B1 launches a
     forward, the eager model's poses (bf16; and in fp32 with TF32 off), its
     time and profile beside the eager forward's; each auxiliary op (fps,
     chamfer, flow, canny, RANSAC voting) on the card against the CPU on the
     same inputs, fp32, TF32 off, timed by CUDA events; the RLE codec through
     its native library against its numpy path;
 18. the last modules: the flagship with ``backbone.int8_mlp=True`` on phase
     4's batch (run after phase 7, while that model is up): one block's
     ``torch._int_mm`` accumulators equal to the CPU's int32 matmul of the
     same codes and to their exact product, the poses' difference from the
     bf16 forward, forward times int8 against bf16 in turns, B1 at 40 a
     forward; ``backbone.remat`` on the RGB recipe at batch 48 for a few
     steps on the same batches, with and without: losses, B1 forward
     launches (76 against 40 a step), peak memory, step times; ``demo_gdrn
     --dets --depth-images --depth-refine --cam-K`` on the RGB-D scene
     against ``run_gdrn_inference(post_mode="depth_refine")`` and B2's
     launches; ``train_gdrn`` at world 1 and at world 2 (two processes over
     gloo on this one card) for a few steps of the RGB recipe, the step-1
     loss and the parameter updates held to world 1's; ``test_gdrn
     --num-processes 2`` on the card against one process.

The scene's sensor depth is analytic (ray-ellipsoid), never rendered by the
kernel under test. Any failure raises (exit code 1). Without a CUDA device
it exits 1 before printing any result. The next-to-last line is the
kernels' JSON record, the last line is {"ok": true, "device": {...}}.

``--timing-only ROOT`` imports the package from the checkout at ROOT (this
one, or an earlier commit unpacked with ``git archive``), builds its
kernels and prints, as its last line, a JSON record of B1's and B2's times
at the flagship shapes through the wrappers that every version has
(``layer_norm``, ``render_depth_xyz_cuda``), and, where the version trains,
B1's backward at batch 48 and one Ranger + EMA step over the flagship
model's parameters: two versions compared in one call on one card, in
turns.
"""

from __future__ import annotations

import json
import math
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
# the kernels each wrapper call launches once (names as the profiler shows them)
LN_FWD_KERNELS = ("layer_norm_rows",)
LN_BWD_KERNELS = ("layer_norm_bwd_tiles", "layer_norm_bwd_reduce")
B2_KERNELS = ("pack_faces_kernel", "raster_kernel")
H100_FP32_FLOPS = 67e12   # dense fp32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12
# cold timing: a 256 MB write evicts the 50 MB L2 before each call; the card
# then spins ~0.5 ms so the call is queued before its start event; a call
# that the host had not queued when the spin ended is timed again behind a
# spin twice as long, at most this many times
FLUSH_BYTES = 256 << 20
SPIN_CYCLES = 1_000_000
COLD_SPIN_DOUBLINGS = 6
# traces kernel_ms takes where one kept no record of the kernels it times
# (seen once at 9 us calls on an H100)
PROFILE_TRIES = 3
# card vs CPU, fp32 flagship: 40 blocks of convs whose algorithms differ
# (cuDNN vs oneDNN) and sum in another order
PARITY_ROT_TOL = 1e-3
PARITY_REL_TOL = 1e-3
# the synthetic RGB-D scene: 21 ellipsoids of 4096 faces (n_lat 33, n_lon 64)
MESH_LAT, MESH_LON = 33, 64
REFINE_OFFSET_M = 0.04
REFINE_T_TOL = 1e-5       # refined t, B2 vs the plain rasterizer (m)
PNP_MODES = ("ransac_pnp", "uncertainty_pnp", "net_iter_pnp")
# PnP from a perfect network's dense outputs must land within these
PNP_R_TOL_DEG = 1.0
PNP_T_TOL_M = 0.01
# the scorer on the card vs the port on the CPU: a render that differs at
# one seam pixel moves one pair's VSD by 1 / union; AR averages 100 such
# threshold pairs over the targets, so AR keys are held to 1e-3
SCORE_CPU_TOL = 1e-3
# perturbations of the GT poses that the scoring ladder scores
LADDER = (("z + 1 cm", (0.0, 0.0, 0.01), 0.0), ("R 5 deg", (0.0, 0.0, 0.0), 5.0),
          ("z + 5 cm, R 15 deg", (0.0, 0.0, 0.05), 15.0))
# training: configs.ycbv_convnext_base() at its batch of 48 on a synthetic
# train split of TRAIN_IMAGES images (8 ellipsoids each), TRAIN_STEPS steps
# with a TRAIN_WARMUP-step warmup, a metrics row every TRAIN_LOG_PERIOD
# steps; step times skip the first TRAIN_SKIP steps (allocator and cuDNN
# warm-up). The loss must fall: on one batch held apart (its own loader
# seed), the total loss less the region CE's closed-form constant (log(65)
# for every pixel outside the mask, over the mask's count: ~2/3 of the total,
# with no gradient) must fall below TRAIN_LOSS_DROP x its value at the
# initial weights. That remainder is the sum of every trainable term.
TRAIN_BATCH = 48
TRAIN_IMAGES = 24
TRAIN_STEPS = 40
TRAIN_WARMUP = 5
TRAIN_LOG_PERIOD = 5
TRAIN_SKIP = 3
TRAIN_LOSS_DROP = 0.8
TRAIN_PROFILE_STEPS = 3
TRAIN_PROFILE_TOP = 15
POSE_LOSSES = ("loss_PM_R", "loss_centroid", "loss_z")
OPT_STEPS = 12            # two lookahead syncs (k = 6) per timing
# B1 backward vs plain: dx as LN_TOL_F32 / one bf16 ulp; dweight and dbias
# within 1e-4 of the sum of the absolute values of their terms (rows are
# summed in another order)
LN_BWD_REL_TOL = 1e-4
# the vector backward's edges (rows, C): one tile of fewer rows than the
# ring has stages, and a last tile cut short; mean / rstd views that start
# this many rows into their buffers (1: misaligned, the scalar path; 4: the
# vector path); calls in a row that must give the same bits
LN_BWD_EDGES = ((1, 1024), (3, 1024), (TRAIN_BATCH * 256 + 5, 512))
LN_BWD_STATS_OFFSETS = (1, 4)
LN_BWD_REPEAT = 20
# card vs CPU, one fp32 step of the tiny config (tests/test_model_train_step.py
# sizes, 21 classes, no warmup): losses relative to max(|loss|, 1); grads
# and params after the step relative to each tensor's largest magnitude
# (convolutions sum in another order on cuDNN and oneDNN). The dual stream's
# grads differ up to 7e-4 of a tensor's largest (its 3-element fc_t bias;
# the card's own run-to-run spread is 2-3e-6), so its params are held to
# what that gradient difference moves them by: per tensor, the grads' limit
# x lr x 2 max|grad| (centralization can double it), plus two fp32 ulps of
# the tensor's largest value (the rounding of p + update)
TRAIN_TINY = {"model.pose_net.num_classes": 21, "model.pose_net.input_res": 64,
              "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
              "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
              "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
              "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32",
              "solver.warmup_iters": 0}
TRAIN_PARITY_LOSS_TOL = 1e-4
TRAIN_PARITY_GRAD_TOL = 1e-3
TRAIN_PARITY_PARAM_TOL = 1e-5
# the recipes' backgrounds: TRAIN_BG_IMAGES 640x480 PNGs of colour gradients
# and noise, from the seed
TRAIN_BG_IMAGES = 32
# colour augmentation and background replacement on the card against their
# plain versions on the CPU, given the same draws, on the first
# AUG_CPU_SAMPLES images of a training batch: the background exactly (selects
# and products by 0 or 1); cosy+aae within AUG_TOL on [0, 255] (the card
# contracts a * b + c into one rounding, and EnhanceSharpness's factor of up
# to 50 and the contrast and colour factors amplify a last-bit difference)
AUG_CPU_SAMPLES = 8
AUG_TOL = 1e-2
# phase 11: configs.ycbv_convnext_base_rgbd() (two convnext_base) at batch
# 48 for TRAIN_RGBD_STEPS steps (a TRAIN_WARMUP-step warmup); its trainable
# loss on a batch held apart must fall below TRAIN_RGBD_LOSS_DROP x its
# value at the initial weights
TRAIN_RGBD_STEPS = 40
TRAIN_RGBD_LOSS_DROP = 0.85
DSTREAM = {"model.pose_net.name": "gdrn_dstream_double_mask",
           "model.pose_net.fuse_type": "cat", "input.with_depth": True}
# pool mode (train.device_pool_frames): POOL_BATCHES batches equal to the
# host batches of the same seed and draws, then POOL_STEPS steps through
# train_gdrn; POOL_FRAMES RGB frames, twice as many mask slots (fewer than
# the split's masks: batches evict)
POOL_FRAMES = 64
POOL_BATCHES = 3
POOL_STEPS = 6
# phases 12-13: the BOP'22 detector recipe configs.yolox("ycbv") (yolox-x at
# 640x640, 21 classes, bf16; TTA at 5 scales x flip, conf 0.001, NMS 0.65) at
# batch DET_BATCH on the RGB-D scene's 24 images, GN and BN, weights from the
# seed; the plain path at the flag default conf DET_CONF_PLAIN; DET_REPS timed
# batches a path. Card vs CPU in fp32 on 2 images: raw outputs within
# DET_PARITY_TOL of each level's largest magnitude (cuDNN and oneDNN sum ~155
# convolutions in another order). demo_gdrn runs on DEMO_IMAGES images.
DET_BATCH = 8
DET_CONF_PLAIN = 0.01
DET_REPS = 5
DET_PARITY_TOL = 1e-3
DEMO_IMAGES = 4
# phase 14: the BOP'22 detector recipe configs.yolox("ycbv") trained through
# train_yolox for YX_STEPS iterations (a YX_WARMUP-iteration warmup, the last
# YX_NOAUG without mosaic and mixup, with L1) at the first batch of
# YX_BATCHES whose one-step peak memory at the largest multiscale size
# (26 x 32 = 832) stays under YX_MEM_GB, on the scene's images less the last
# YX_HELD; on a batch drawn without augmentation from those YX_HELD images,
# each of loss_iou, loss_obj and loss_cls at the EMA weights must fall below
# YX_LOSS_DROP x its value at the initial weights. Step times skip the first TRAIN_SKIP steps. The BN variant trains
# YX_BN_STEPS iterations at batch YX_BN_BATCH; its running statistics after
# one more step must equal a float64 recomputation of the biased update on
# that step's BN inputs within YX_BN_TOL of each tensor's largest value.
# Card vs CPU, one fp32 step of a BN YOLOX (dep 0.33, wid 0.125, 3 classes)
# at 128 x 128: the loss within YX_PAR_LOSS_TOL relative, the BN running
# statistics after the step within YX_PAR_TOL and the gradients within
# YX_PAR_GRAD_TOL of each tensor's largest magnitude (the card read 1.11e-4
# in PERF.md's runs C and D), the parameters within
# YX_PAR_TOL of theirs plus what the gradients' difference moves them by
# (the step is lr x the centralized gradient: 2 lr max|dg|; the biases start
# at 0, so theirs carries the gradient's relative error): the backward through
# ~100 BatchNorms in training mode amplifies summation-order differences
# (on the CPU alone, inputs moved by 1e-7 relative move these gradients by
# 1.1-3.5e-4 of their largest; the JAX package and the port differ by 7e-4,
# tests/test_torch_yolox_step.py). simOTA on the card equals the CPU's on a
# tie-free batch at 640 x 640 (fg and matched GT exactly, IoU within 1e-6).
# It learns: yolox_s at 64 x 64 on a two-class split of YX_LEARN_IMAGES
# images (two shapes a 160 x 120 image, as tests/test_yolox_pipeline.py's
# cubes), YX_LEARN_STEPS iterations at batch 8 through train_yolox, AP50 of
# the EMA weights by evaluate_yolox_records at least YX_LEARN_AP50.
YX_BATCHES = (32, 16, 8)
YX_PROBE_SIZE = 832
YX_MEM_GB = 75.0
YX_STEPS = 40
YX_WARMUP = 5
YX_NOAUG = 10
YX_LOG_PERIOD = 5
YX_LOSS_DROP = 0.8
YX_HELD = 8
YX_BN_STEPS = 3
YX_BN_BATCH = 8
YX_BN_TOL = 1e-5
YX_PAR_LOSS_TOL = 1e-5
YX_PAR_TOL = 1e-4
YX_PAR_LR = 1e-3
YX_PAR_GRAD_TOL = 5e-4
# phase 15: the GDRN variants at the flagship's width (21 classes, bf16, batch
# 64, 256^2 input), seeded weights, served on phase 4's RGB scene (V6: the
# RGB-D scene) through run_gdrn_inference(post_mode="direct"). Each: (tag,
# what it is, Config() overrides, B1 launches per forward, RGB-D).
P = "model.pose_net."
VARIANTS = (
    ("V1", "resnet34, single mask, ConvPnPNet (GDR-Net's layout)",
     {P + "backbone.name": "resnet34", P + "geo_head.name": "top_down_mask_xyz_region"}, 0, False),
    ("V2", "resnest50, single mask, CE_coor 64 bins, cls2reg, ConvPnPNetCls",
     {P + "backbone.name": "resnest50", P + "geo_head.name": "top_down_mask_xyz_region",
      P + "loss.xyz_loss_type": "CE_coor", P + "geo_head.xyz_num_bins": 64,
      P + "name": "gdrn_cls2reg", P + "pnp_net.name": "conv_pnp_net_cls"}, 0, False),
    ("V3", "convnext_base stages 0-3, FPN head, SimplePointPnPNet",
     {P + "geo_head.name": "fpn_mask_xyz_region", P + "pnp_net.name": "point_pnp"}, 40, False),
    ("V4", "resnet18_8s, conv-only head with ACON, ConvPnPNet with LN, output 32^2",
     {P + "backbone.name": "resnet18_8s", P + "geo_head.name": "conv_mask_xyz_region",
      P + "geo_head.act": "acon", P + "pnp_net.norm": "LN", P + "output_res": 32}, 0, False),
    ("V5", "cspdarknet, double mask, ConvPnPNet without norm",
     {P + "backbone.name": "cspdarknet", P + "pnp_net.norm": "none"}, 0, False),
    ("V6", "convnext_base x 2, dual stream fused by ConvFuseNet, double mask, ConvPnPNet",
     {P + "fuse_type": "conv"}, 80, True),
)
VARIANT_SEED = SEED + 20
VARIANT_PROFILE_CALLS = 3
VARIANT_PROFILE_TOP = 8
# phase 16: the sweep over two core datasets and the per-object path
SWEEP_DATASETS = ("ycbv", "lmo")
LMO_SCENE = 2               # lmo's test scene
SO_OBJECTS = ("002_master_chef_can", "003_cracker_box")
STRIP_POSE_TOL = 1e-5       # stripped EMA weights vs the checkpoint's: the same weights
# phase 17: export and the auxiliary ops
EXPORT_BF16_TOL = 2 ** -7   # one bf16 ulp at 1: rot, and trans over its largest
EXPORT_F32_TOL = 1e-3
FPS_SHAPE = (16384, 64)     # points, samples
CHAMFER_SHAPE = (64, 2048, 2048)
AUX_IMAGES = (8, 480, 640)  # flow and canny
RANSAC_SHAPE = (4, 480, 640, 9, 128)    # images, H, W, keypoints, hypotheses
RANSAC_CPU_IMAGES = 1       # the CPU repeats the first image's keypoints
CHAMFER_REL_TOL = 1e-5
FLOW_TOL = 1e-4             # px
RANSAC_TOL = 1e-3           # px
CANNY_MARGIN = 1e-4
RLE_MASKS = 8
YX_LEARN_IMAGES = 6
YX_LEARN_STEPS = 200
YX_LEARN_AP50 = 0.5
# phase 18: int8 serving on phase 4's batch (one block's accumulators checked:
# stage 2 block 13, a middle block of the deepest stage; the CPU's int32
# matmul on its first INT8_CPU_ROWS rows), remat for REMAT_STEPS steps of the
# RGB recipe on the same batches (step 1's loss bit-equal, later ones within
# REMAT_LOSS_TOL relative: the recompute is exact, cuDNN's backward need not
# be deterministic; B1 76 forward launches a step: 36 blocks twice + the stem
# and 3 downsamples), the demo's depth refine vs run_gdrn_inference (the same
# device work on the same inputs: within DEMO_REFINE_T_TOL), DDP_STEPS steps at
# world 1 and world DDP_WORLD: the step-1 loss within DDP_LOSS_TOL relative
# (bf16 forwards of 48 vs 2 x 24 ROIs; the card read 4.7e-7), the parameter
# updates within DDP_UPDATE_TOL of their L2 norm (read 4.5e-3: Ranger's first
# steps move each weight by about lr x sign(g), and a weight whose bf16
# gradient is near 0 may flip), and test_gdrn over two processes vs one within
# DDP_EVAL_R_TOL on R and DDP_EVAL_T_TOL_MM on t (bf16 forwards of other batch
# compositions; read 0).
INT8_BLOCK = (2, 13)
INT8_CPU_ROWS = 256
REMAT_STEPS = 3
REMAT_LR = 1e-4
REMAT_LOSS_TOL = 1e-3
REMAT_LN_FWD = 76
DEMO_REFINE_T_TOL = 1e-5
DDP_STEPS = 3
DDP_WORLD = 2
DDP_LOSS_TOL = 1e-4
DDP_UPDATE_TOL = 0.05
DDP_EVAL_R_TOL = 1e-3
DDP_EVAL_T_TOL_MM = 1.0


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
    before each, by CUDA events around each call. Each call is queued behind
    a spin on the card, so that the events time the card alone. Where the
    spin had ended before the host had queued the call's end event (an
    event recorded after the spin had completed by then), the events may
    also time the host's delay: that call is timed again behind a spin twice
    as long, up to COLD_SPIN_DOUBLINGS times, and the redo is logged."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        for doubling in range(COLD_SPIN_DOUBLINGS + 1):
            flush.fill_(1.0)
            torch.cuda._sleep(SPIN_CYCLES << doubling)
            spun = torch.cuda.Event()
            spun.record()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            queued = not spun.query()
            end.synchronize()
            if queued:
                break
            log(f"cold_ms: the spin of {SPIN_CYCLES << doubling} cycles ended before the call "
                f"was queued ({start.elapsed_time(end):.4f} ms); timing it again")
        check(queued, f"cold_ms: a call was not queued within a spin of "
                      f"{SPIN_CYCLES << COLD_SPIN_DOUBLINGS} cycles")
        total += start.elapsed_time(end)
    del flush
    return total / reps


def device_ms(fn, kernels=None):
    """Device time per call of fn(), summed over every kernel it launches;
    or, where `kernels` names the kernels a call launches once each, over
    those (kernel_ms's per-record mean: robust to dropped records)."""
    if kernels is None:
        return kernel_ms(fn, ("",))[""]
    ms = kernel_ms(fn, kernels, per_call=dict.fromkeys(kernels, 1))
    return sum(ms.values()) if all(v is not None for v in ms.values()) else None


def _cuda_records(fn, iters):
    """torch.profiler's CUDA entries (key_averages, one per kernel name) over
    `iters` back-to-back calls of fn(), after one call to warm up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _device_us(e):
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)


def kernel_ms(fn, names, iters=20, per_call=None):
    """Device time per call of fn() in the kernels whose names contain each
    of `names`, by torch.profiler over `iters` back-to-back calls (None where
    no such kernel shows). per_call[name], where given, is the number of
    such kernels a call launches: the time per call is then the mean of the
    records the trace kept times per_call, since the profiler can drop
    kernel records (one run on an H100 kept 7 of 20 calls' records), and
    a short trace is logged. A trace that kept no record of any of `names`
    is taken again, up to PROFILE_TRIES traces. Name only kernels that a
    call launches itself, never the copies it may make."""
    for _ in range(PROFILE_TRIES):
        records = _cuda_records(fn, iters)
        out = {}
        for n in names:
            ev = [e for e in records if n in e.key]
            us = sum(_device_us(e) for e in ev)
            out[n] = us / iters / 1e3 if us else None
            k = (per_call or {}).get(n)
            count = sum(e.count for e in ev)
            if k and us:
                out[n] = us / (count / k) / 1e3
                if count != iters * k:
                    log(f"profiler kept {count} of {iters * k} kernel records of "
                        f"{n or 'fn'!r}; time per call from their mean")
        if any(v is not None for v in out.values()):
            break
        log(f"the profiler kept no kernel record of {names}; tracing again")
    return out


def profile_calls(fn, n):
    """torch.profiler over n back-to-back calls of fn() (one call before, to
    warm up): wall ms a call (host clock, synchronised), device ms a call
    summed over kernels and copies (user annotations excluded: a CPU op's
    range repeats its kernels' time), their count a call, and (name, ms a
    call, count a call) sorted by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = lambda e: (getattr(e, "self_device_time_total", None)          # noqa: E731
                     or getattr(e, "self_cuda_time_total", 0.0))
    ev = [(e.key, dev(e) / 1e3 / n, e.count // n)
          for e in prof.key_averages() if e.device_type == DeviceType.CUDA and dev(e) > 0
          and not getattr(e, "is_user_annotation", False)]
    ev.sort(key=lambda e: -e[1])
    return wall_ms, sum(ms for _, ms, _ in ev), sum(c for *_, c in ev), ev


def phase_device(ptxas=True):
    name = torch.cuda.get_device_name(0)
    log(f"[1/18] device: {name} x{torch.cuda.device_count()}  torch "
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
    log(f"[1/18] built csrc/layer_norm.cu and csrc/raster.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    if ptxas:
        ptxas_backward()
    return name, card


def _demangle(names):
    """C++ names of mangled symbols, through c++filt (or CUDA's cu++filt)
    where the machine has one, else as they are."""
    import shutil
    tool = shutil.which("c++filt") or shutil.which("cu++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    return out if len(out) == len(names) else list(names)


PTXAS_BACKWARD = {}      # B1's backward instantiations as ptxas built them (phase 1)


def ptxas_backward():
    """B1's backward kernels as ptxas built them (-Xptxas -v in the build
    log): registers, stack and spills of every instantiation; fails on a
    spill or if the log names no backward kernel."""
    from gdrnpp_bop2022_torch.utils.cuda_build import build_log, ptxas_usage
    usage = {k: v for k, v in ptxas_usage(build_log("layer_norm")).items()
             if "layer_norm_bwd" in k}
    check(usage, "the build log of csrc/layer_norm.cu names no backward kernel (-Xptxas -v)")
    for full, (k, v) in zip(_demangle(list(usage)), usage.items()):
        name = full.replace("(anonymous namespace)::", "").split("(")[0].replace("void ", "")
        log(f"[1/18] ptxas {name}: {v.get('registers')} registers, stack "
            f"{v.get('stack')} B, spill stores {v.get('spill_stores')} B, spill loads "
            f"{v.get('spill_loads')} B")
        check(v.get("spill_stores") == 0 and v.get("spill_loads") == 0,
              f"ptxas spilled in {full}: {v}")
        PTXAS_BACKWARD[name] = v
    return usage


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
        k = device_ms(lambda: layer_norm(x, w, b), kernels=LN_FWD_KERNELS)
        kc = cold_ms(lambda: layer_norm(x, w, b))
        p = device_ms(lambda: layer_norm_ref(x, w, b))
        lib = device_ms(lambda: F.layer_norm(x, (C,), wb, bb, 1e-6))
        libc = cold_ms(lambda: F.layer_norm(x, (C,), wb, bb, 1e-6))
        y = torch.empty_like(x)         # a copy of the same bytes: what the card reaches
        cp = cold_ms(lambda: y.copy_(x))
        for key, v in zip(t, (k, kc, p, lib, libc, cp)):
            t[key] += n * v
        n_bytes += n * (2 * x.numel() * x.element_size() + 2 * C * 4)
        log(f"[2/18] B1 rows={BATCH * r} C={C} bfloat16 x{n}: kernel hot {k:.4f} ms cold "
            f"{kc:.4f} ms, plain {p:.4f} ms, F.layer_norm hot {lib:.4f} ms cold {libc:.4f} ms,"
            f" copy_ cold {cp:.4f} ms")
    t["bound_ms"] = n_bytes / H100_BYTES_PER_S * 1e3
    log(f"[2/18] B1 per forward at batch {BATCH} (40 LayerNorms, bf16): kernel hot "
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
        log(f"[2/18] B1 rows={rows} C={C} {str(dt)[6:]} offset={off} "
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


def write_models(models_dir, axes_mm, obj_ids=None):
    """Ellipsoid models as PLY files + models_info.json (mm), one per axes
    row, with the ids obj_ids (default 1, 2, ...)."""
    from gdrnpp_bop2022_torch.bop.inout import save_json
    os.makedirs(models_dir)
    info = {}
    for oid, a in zip(obj_ids or range(1, len(axes_mm) + 1), axes_mm):
        pts, faces = ellipsoid_mesh(a)
        write_ply(os.path.join(models_dir, f"obj_{oid:06d}.ply"), pts, faces)
        info[str(oid)] = {"diameter": float(2 * a.max()), "min_x": -a[0], "min_y": -a[1],
                          "min_z": -a[2], "size_x": 2 * a[0], "size_y": 2 * a[1],
                          "size_z": 2 * a[2]}
    save_json(os.path.join(models_dir, "models_info.json"), info)


def make_rgbd_scene(root, rs, dataset="ycbv", scene_id=48):
    """A BOP test split of N_IMAGES 480x640 RGB + depth PNGs (the dataset's
    object ids and camera, depth_scale 0.1) with DETS_PER_IMAGE ellipsoids
    each (as many as the dataset has objects, if fewer; their visible
    fractions in scene_gt_info.json), one ellipsoid model per object as PLY
    + models_info.json, and a detections file; root is <dataset root>/<dataset>."""
    import cv2
    from gdrnpp_bop2022_torch.bop.inout import save_json
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    meta = get_meta(dataset)
    K = meta.camera_matrix.astype(np.float64)
    obj_ids = meta.obj_ids()
    axes_mm = rs.uniform(25.0, 100.0, (len(obj_ids), 3))
    models_dir = os.path.join(root, "models")
    write_models(models_dir, axes_mm, obj_ids)

    sdir = os.path.join(root, "test", f"{scene_id:06d}")
    for sub in ("rgb", "depth"):
        os.makedirs(os.path.join(sdir, sub))
    H, W = meta.height, meta.width
    gt, info, cam, dets = {}, {}, {}, {}
    yy, xx = np.mgrid[0:H, 0:W]
    for im in range(N_IMAGES):
        depth = np.zeros((H, W))
        shade = np.zeros((H, W))
        objs = rs.choice(np.asarray(obj_ids), min(DETS_PER_IMAGE, len(obj_ids)), replace=False)
        gt[str(im)], boxes, own = [], [], []
        for o in objs:
            ax = axes_mm[obj_ids.index(o)] * 1e-3
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
            own.append((y0, x0, d, [int(bx), int(by), int(xs.max() - xs.min() + 1),
                                    int(ys.max() - ys.min() + 1)]))
        # BOP's visible fraction: the object's pixels that are in front
        info[str(im)] = [{"bbox_obj": box, "bbox_visib": box, "visib_fract": float(
            ((d > 0) & (depth[y0:y0 + d.shape[0], x0:x0 + d.shape[1]] == d)).sum()
            / (d > 0).sum())} for y0, x0, d, box in own]
        img = (np.stack([shade + xx * 0.1, shade * 0.8 + yy * 0.1, shade * 0.6], -1)
               + rs.randint(0, 30, (H, W, 3))) % 256
        cv2.imwrite(os.path.join(sdir, "rgb", f"{im:06d}.png"), img.astype(np.uint8))
        cv2.imwrite(os.path.join(sdir, "depth", f"{im:06d}.png"),
                    np.round(depth * 10000).astype(np.uint16))   # 0.1 mm units
        cam[str(im)] = {"cam_K": K.ravel().tolist(), "depth_scale": 0.1}
        dets[f"{scene_id}/{im}"] = boxes
    save_json(os.path.join(sdir, "scene_gt.json"), gt)
    save_json(os.path.join(sdir, "scene_gt_info.json"), info)
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


def _raster_case(label, verts, faces, R, t, K, H, W, tag="[3/18]"):
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
    log(f"{tag} B2 {label}: packed faces and boxes == torch packing and face_screen_boxes "
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
    k = kernel_ms(call, ("raster_kernel", "pack_faces_kernel"),
                  per_call={"raster_kernel": 1, "pack_faces_kernel": 1})
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
    log(f"[3/18] B2 flagship culling: faces per {RASTER_TILE[0]}x{RASTER_TILE[1]} tile mean "
        f"{float(pt.mean()):.1f}, max {int(pt.max())} of {F}; {bd['pairs']:.4e} pixel-face "
        f"pairs inside the boxes vs {bd['all_pairs']:.4e} all pairs")
    # times at the flagship, depth only (the mode depth refinement runs)
    t = b2_times(flag)
    k_attr_ms = cuda_ms(lambda: render_depth_xyz_cuda(*flag))
    full_ms = device_ms(lambda: render_depth_xyz_cuda(*full, need_xyz=False),
                        kernels=B2_KERNELS)
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
    log(f"[3/18] B2 flagship depth only: wrapper hot {t['ms']:.4f} ms, cold "
        f"{t['cold_ms']:.4f} ms (2 launches; the raster kernel alone {kernel_only_ms:.4f} ms "
        f"by events, {fmt(t['kernel_ms'])} by the profiler, the pack kernel "
        f"{fmt(t['pack_kernel_ms'])}); attribute mode {k_attr_ms:.4f} ms; plain "
        f"{p_ms:.4f} ms; bound {bd['bound_ms']:.4f} ms ({bd['pairs']:.4e} tests x "
        f"{RASTER_OPS_PER_TEST} fp32 ops at 67 TFLOP/s, {bd['bound_by']}), all-pairs bound "
        f"{bd['all_pairs_bound_ms']:.4f} ms  [{card}]")
    log(f"[3/18] B2 full image depth only (2 ROIs at 480x640, {F} faces): pack + raster "
        f"kernels {full_ms:.4f} ms of device time per call  [{card}]")
    vsd = [_vsd_shape(card, vsd_shape_input(scene, bank, np.random.RandomState(SEED + 20 + i),
                                            n, bh, bw), n)
           for i, (bh, bw, n) in enumerate(vsd_shapes())]
    return {"vsd_shapes": vsd, "max_abs_err": worst, "ms": t["ms"], "cold_ms": t["cold_ms"], "plain_ms": p_ms,
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "all_pairs_bound_ms": bd["all_pairs_bound_ms"], "library_ms": None,
            "kernel_ms": kernel_only_ms}


def vsd_shapes():
    """(bh, bw, pairs per call) of the scorer's B2 calls on a 480x640 image:
    its image-grid buckets with eval/scorer.py's chunk sizes, and the full
    image (the fallback of pairs no bucket holds)."""
    from gdrnpp_bop2022_torch.eval.scorer import _VSD_FULL_CHUNK, _VSD_WIN_CHUNK
    from gdrnpp_bop2022_torch.eval.vsd import vsd_bbox_plan
    _, _, buckets = vsd_bbox_plan(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3, 3)),
                                  np.zeros(0), 480, 640)
    return [(bh, bw, max(8, _VSD_WIN_CHUNK * 128 * 128 // (bh * bw))) for bh, bw in buckets] \
        + [(480, 640, _VSD_FULL_CHUNK)]


def vsd_shape_input(scene, bank, rs, n, bh, bw):
    """n objects of the scene's kind (its 21 meshes, its camera) posed so that
    eval/vsd.py::vsd_bbox_plan puts each in the (bh, bw) bucket, with K's
    principal point shifted to the window's origin as vsd_batch_bbox does;
    at (480, 640) any pose in front of the camera on the full image."""
    from gdrnpp_bop2022_torch.eval.vsd import vsd_bbox_plan
    K = scene["K"]
    H, W = 480, 640
    radii = np.linalg.norm(bank.verts.astype(np.float64), axis=-1).max(1)
    m = 60 * n
    lab = rs.randint(0, 21, m)
    z = rs.uniform(0.45, 1.4, m)
    t = z[:, None] * pixel_rays(K, rs.uniform(0, W, m), rs.uniform(0, H, m))
    bucket, offs, buckets = vsd_bbox_plan(t, t, np.tile(K, (m, 1, 1)), radii[lab], H, W)
    if (bh, bw) == (H, W):
        pick = np.arange(n)
        offs[:] = 0
    else:
        pick = np.where(bucket == buckets.index((bh, bw)))[0][:n]
        check(len(pick) == n, f"only {len(pick)} of {m} poses fit the {bh}x{bw} bucket")
    Kw = np.tile(K, (n, 1, 1))
    Kw[:, 0, 2] -= offs[pick, 1]
    Kw[:, 1, 2] -= offs[pick, 0]
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    lab_d = torch.as_tensor(lab[pick], device="cuda")
    return (f32(bank.verts)[lab_d], torch.as_tensor(bank.faces, device="cuda")[lab_d],
            f32(np.stack([random_rotation(rs) for _ in range(n)])), f32(t[pick]), f32(Kw),
            bh, bw)


def _vsd_shape(card, inp, n):
    """B2 depth-only at one of the scorer's shapes: the pack kernel and boxes
    against the torch packing bit for bit, the render against the plain
    version bit for bit; hot, cold, the raster kernel alone, the raster
    kernel on empty boxes (the box tests alone), faces per tile, bound."""
    from gdrnpp_bop2022_torch.ops.raster import (_kernels, _pack_face_data, face_major,
                                                 face_screen_boxes, pack_faces_cuda,
                                                 render_depth_xyz_cuda, transform_verts)
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
    verts, faces, R, t, K, H, W = inp
    label = f"VSD {H}x{W} x{n}"
    packed, boxes = pack_faces_cuda(*inp, with_attrs=False)
    fd = _pack_face_data(transform_verts(verts, R, t), verts, faces, K, with_attrs=False)
    check(torch.equal(packed, face_major(fd)) and torch.equal(boxes, face_screen_boxes(fd, H, W)),
          f"B2 {label}: the pack kernel differs from the torch packing or boxes")
    d = render_depth_xyz_cuda(*inp, need_xyz=False)[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_ref = render_depth_xyz_batch(*inp, need_xyz=False, max_block=PLAIN_MAX_BLOCK)[0]
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    hit = d_ref > 0
    check(bool(hit.any()), f"B2 {label}: nothing rendered")
    check(torch.equal(d, d_ref), f"B2 {label}: depth-only render differs from the plain "
                                 f"version (max {float((d - d_ref).abs().max())})")
    call = lambda: render_depth_xyz_cuda(*inp, need_xyz=False)      # noqa: E731
    k = kernel_ms(call, ("raster_kernel", "pack_faces_kernel"),
                  per_call={"raster_kernel": 1, "pack_faces_kernel": 1})
    hot, cold = device_ms(call, kernels=B2_KERNELS), cold_ms(call)
    empty = torch.empty_like(boxes)
    empty[..., 0:2], empty[..., 2:4] = 0, -1
    out = torch.empty_like(d)
    stream = torch.cuda.current_stream().cuda_stream
    launch = lambda: _kernels().gdrn_raster_fwd(packed.data_ptr(), empty.data_ptr(), n,  # noqa: E731
                                                faces.shape[1], H, W, out.data_ptr(), None,
                                                0, stream)
    check(launch() == 0, f"B2 {label}: direct launch failed")
    box_ms = kernel_ms(launch, ("raster_kernel",), per_call={"raster_kernel": 1})["raster_kernel"]
    bd = raster_bound(*inp)
    pt = bd["per_tile"].float()
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    log(f"[3/18] B2 {label} ({faces.shape[1]} faces): == plain version bit for bit "
        f"({int(hit.sum())} px hit); hot {hot:.4f} ms, cold {cold:.4f} ms per call (the "
        f"raster kernel {fmt(k['raster_kernel'])}, pack {fmt(k['pack_faces_kernel'])}; the "
        f"raster kernel on empty boxes, i.e. its box tests alone, {fmt(box_ms)}); faces per "
        f"{RASTER_TILE[0]}x{RASTER_TILE[1]} tile mean {float(pt.mean()):.1f} max "
        f"{int(pt.max())}; bound {bd['bound_ms']:.4f} ms ({bd['pairs']:.4e} pixel-face pairs "
        f"in the boxes, {bd['bound_by']}); plain {plain_ms:.1f} ms; "
        f"{2.0 / n:.4f} calls per scored pair  [{card}]")
    return {"shape": [H, W], "pairs_per_call": n, "ms": hot, "cold_ms": cold,
            "kernel_ms": k["raster_kernel"], "box_tests_ms": box_ms, "plain_ms": plain_ms,
            "faces_per_tile_mean": float(pt.mean()), "faces_per_tile_max": int(pt.max()),
            "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"],
            "calls_per_pair": 2.0 / n}


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

    kw = dict(input_res=pc.input_res, output_res=pc.output_res,
              pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std)
    stats = {}
    layer_norm.launches = 0                       # count this path only
    results = run_gdrn_inference(model, batches, extents, post_mode="direct", stats=stats,
                                 **kw)
    launches = layer_norm.launches
    n_rois = N_IMAGES * DETS_PER_IMAGE
    check(forwards[0] == stats["n_batches"] + 1, f"{forwards[0]} forwards for "
          f"{stats['n_batches']} batches + warm-up")
    check(launches == LN_PER_FORWARD * forwards[0],
          f"layer_norm launches {launches} != 40 x {forwards[0]} forwards")
    orth = _check_rows(results, n_rois, tmp, "rgb")
    log(f"[4/18] RGB: served {n_rois} ROIs ({N_IMAGES} images) in {stats['n_batches']} "
        f"batches of {BATCH} + warm-up: {forwards[0]} forwards, layer_norm "
        f"launches {launches} = 40 x {forwards[0]}; rows finite, "
        f"max|R^T R - I| = {orth:.2e}; CSV {len(results)} rows")
    log(f"[4/18] RGB serving (ROI crop + forward + decode, host clock after "
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
    log(f"[4/18] GDRN forward alone at batch {BATCH}, bf16: {fwd_ms:.3f} ms = "
        f"{BATCH / fwd_ms * 1e3:.1f} ROI/s  [{card}]")
    serve = {"model": model, "forwards": forwards, "extents": extents, "kw": kw,
             "batches": lambda: iter_test_batches(by_im, dets, batch_size=BATCH),
             "rb": rb, "fwd_ms": fwd_ms, "mask_loss_type": pc.loss.mask_loss_type}
    return rb, serve


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
    log(f"[5/18] RGB-D: served {n_rois} ROIs ({N_IMAGES} images, depth PNGs, bank of "
        f"{bank.faces.shape[0]} meshes x {bank.faces.shape[1]} faces) in {nb} batches of "
        f"{BATCH} + warm-up, post_mode=depth_refine x{iters}: {forwards[0]} forwards, "
        f"layer_norm launches {ln_launches} = 80 x {forwards[0]}, raster launches "
        f"{r_launches} = {iters} x {nb + 1} (and as many pack launches); rows finite, max|R^T R - I| = {orth:.2e}; "
        f"CSV {len(results)} rows")
    log(f"[5/18] RGB-D serving (ROI + depth crops + forward + depth refine, host clock "
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
    log(f"[5/18] RGB-D forward alone at batch {BATCH}, bf16: {fwd_ms:.3f} ms = "
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
    log(f"[6/18] depth refine at batch {BATCH} from GT t + {REFINE_OFFSET_M * 100:.0f} cm "
        f"in z, 2 iterations: z error max {worst_z * 1e3:.3f} mm, mean "
        f"{float(z_err.mean()) * 1e3:.3f} mm (limit {0.3 * REFINE_OFFSET_M * 1e3:.1f} mm); "
        f"B2 vs plain rasterizer max |dt| = {dt:.3g} m  [{card}]")


def _rot_x(deg):
    a = np.deg2rad(deg)
    return np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])


def _pose_errors(R, t, R_gt, t_gt):
    """Rotation (degrees) and translation (m) errors per ROI, on the host."""
    R, t, R_gt, t_gt = (a.detach().double().cpu().numpy() for a in (R, t, R_gt, t_gt))
    cos = np.clip((np.einsum("bij,bij->b", R, R_gt) - 1) / 2, -1, 1)
    return np.rad2deg(np.arccos(cos)), np.linalg.norm(t - t_gt, axis=-1)


def phase_pnp(card, scene, bank, serve, tmp):
    """The three PnP paths from a perfect network's dense outputs (B2's
    attribute mode at 64 known poses), then the RGB flagship served with
    each PnP post_mode."""
    from gdrnpp_bop2022_torch.engine.inference import (decode_dense_outputs,
                                                       run_gdrn_inference)
    from gdrnpp_bop2022_torch.eval import pnp_eval
    from gdrnpp_bop2022_torch.geometry.camera import centered_crop_K
    from gdrnpp_bop2022_torch.ops.crop import affine_grid_from_boxes
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda

    rb = refine_batch(scene, bank, np.random.RandomState(SEED + 9))
    n, res = rb["R"].shape[0], rb["out_res"]
    cK = centered_crop_K(rb["K"], rb["centers"], rb["scales"], res)
    depth, xyz = render_depth_xyz_cuda(rb["verts"], rb["faces"], rb["R"], rb["t"], cK, res, res)
    mask = (depth > 0).float()
    xyz_n = (xyz / rb["extents"][:, None, None] + 0.5) * mask[..., None]
    im_wh = torch.tensor([640.0, 480.0], device="cuda")
    c2d = affine_grid_from_boxes(rb["centers"], rb["scales"], res) / im_wh
    args = (mask, xyz_n, c2d, im_wh.expand(n, 2), rb["extents"], rb["K"])
    R0 = rb["R"] @ torch.as_tensor(_rot_x(5.0), dtype=torch.float32, device="cuda")
    t0 = rb["t"] + torch.tensor([0.01, -0.01, 0.02], device="cuda")
    gen = torch.Generator(device="cuda")
    paths = {
        "ransac_pnp": lambda: pnp_eval.pose_from_dense_ransac(
            *args, generator=gen.manual_seed(SEED))[:2],
        "uncertainty_pnp": lambda: pnp_eval.pose_from_dense_uncertainty(*args),
        "net_iter_pnp": lambda: pnp_eval.pose_from_dense_net_iter(*args, R0=R0, t0=t0)}
    for name, fn in paths.items():
        with torch.inference_mode():
            R, t = fn()
            ms = cuda_ms(fn, iters=5, warmup=1)
        r_err, t_err = _pose_errors(R, t, rb["R"], rb["t"])
        check(r_err.max() < PNP_R_TOL_DEG and t_err.max() < PNP_T_TOL_M,
              f"{name} from perfect dense outputs: R error {r_err.max()} deg, t error "
              f"{t_err.max()} m")
        log(f"[7/18] {name} recovers {n} known poses from B2-rendered XYZ / mask / 2D coords "
            f"at {res}x{res}: R error max {r_err.max():.4f} deg, t error max "
            f"{t_err.max() * 1e3:.3f} mm (limits {PNP_R_TOL_DEG} deg, "
            f"{PNP_T_TOL_M * 1e3:.0f} mm); {ms:.3f} ms per batch of {n}  [{card}]")

    # the RGB flagship served with each PnP post mode
    model, forwards, kw = serve["model"], serve["forwards"], serve["kw"]
    with torch.inference_mode():
        out = model(**serve["rb"])
        xyz_p, mask_p = decode_dense_outputs(out, serve["mask_loss_type"])
        rbs = serve["rb"]
        dargs = (mask_p, xyz_p, rbs["roi_coord_2d"], im_wh.expand(BATCH, 2),
                 rbs["roi_extents"], rbs["roi_cams"])
    post = {"ransac_pnp": lambda: pnp_eval.pose_from_dense_ransac(
                *dargs, generator=gen.manual_seed(SEED))[:2],
            "uncertainty_pnp": lambda: pnp_eval.pose_from_dense_uncertainty(
                *dargs, R0=out["rot"], t0=out["trans"]),
            "net_iter_pnp": lambda: pnp_eval.pose_from_dense_net_iter(
                *dargs, R0=out["rot"], t0=out["trans"])}
    n_rois = N_IMAGES * DETS_PER_IMAGE
    times = {}
    for mode in PNP_MODES:
        stats = {}
        forwards[0] = 0
        layer_norm.launches = 0                   # count this path only
        results = run_gdrn_inference(model, serve["batches"](), serve["extents"],
                                     post_mode=mode, stats=stats, seed=SEED, **kw)
        launches = layer_norm.launches
        nb = stats["n_batches"]
        check(forwards[0] == nb + 1, f"{mode}: {forwards[0]} forwards for {nb} batches")
        check(launches == LN_PER_FORWARD * forwards[0],
              f"{mode}: layer_norm launches {launches} != 40 x {forwards[0]} forwards")
        orth = _check_rows(results, n_rois, tmp, mode)
        with torch.inference_mode():
            post_ms = cuda_ms(post[mode], iters=5, warmup=1)
        times[mode] = {"post_ms": post_ms, "p50_ms": stats["p50_ms"],
                       "rois_per_sec": stats["rois_per_sec"], "launches": launches}
        log(f"[7/18] RGB post_mode={mode}: served {n_rois} ROIs in {nb} batches of {BATCH} + "
            f"warm-up, layer_norm launches {launches} = 40 x {forwards[0]}; rows finite, "
            f"max|R^T R - I| = {orth:.2e}; {stats['rois_per_sec']:.1f} ROI/s, p50 "
            f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms per batch; the PnP step "
            f"alone {post_ms:.3f} ms per batch beside the {serve['fwd_ms']:.3f} ms forward  "
            f"[{card}]")
    return times


def _scene_poses(scene, bank):
    """The RGB-D scene's GT rows, test-depth getter and per-image plan area."""
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split, load_depth
    from gdrnpp_bop2022_torch.eval.vsd import vsd_bbox_plan
    meta = scene["meta"]
    records = index_bop_split(scene["split_dir"], meta)
    gts = [{"scene_id": r.scene_id, "im_id": r.im_id, "obj_id": r.obj_id,
            "R": r.pose[:, :3], "t": r.pose[:, 3], "visib_fract": r.visib_fract}
           for r in records]
    depths = {}
    for r in records:
        if (r.scene_id, r.im_id) not in depths:
            depths[(r.scene_id, r.im_id)] = load_depth(r.depth_path, r.depth_scale,
                                                       meta.depth_factor)
    radii = np.linalg.norm(bank.verts.astype(np.float64), axis=-1).max(1)
    t = np.stack([g["t"] for g in gts])
    lab = np.array([bank.obj_ids.index(g["obj_id"]) for g in gts])
    bucket, _, buckets = vsd_bbox_plan(t, t, np.tile(scene["K"], (len(t), 1, 1)), radii[lab],
                                       480, 640)
    area = {}
    for g, b in zip(gts, bucket):
        h, w = buckets[b] if b >= 0 else (480, 640)
        area[g["im_id"]] = area.get(g["im_id"], 0) + h * w
    return gts, depths, area


def _estimates(gts, K, dt=(0.0, 0.0, 0.0), deg=0.0):
    dR = _rot_x(deg)
    return [{**g, "R": (g["R"] @ dR).astype(np.float32),
             "t": (g["t"] + np.asarray(dt)).astype(np.float32), "score": 1.0,
             "K": K.astype(np.float32)} for g in gts]


def _union_counts(R_est, t_est, R_gt, t_gt, depth, Ks, verts, faces, delta=0.015):
    """Each pair's BOP19 visibility union on the full image (eval/vsd.py's
    masks): the pixel count one pixel's share of VSD is taken of."""
    from gdrnpp_bop2022_torch.eval.vsd import _visib_mask_bop19, depth_to_dist
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz
    H, W = depth.shape[1:]
    d_est = render_depth_xyz(verts, faces, R_est, t_est, Ks, H, W, need_xyz=False)[0]
    d_gt = render_depth_xyz(verts, faces, R_gt, t_gt, Ks, H, W, need_xyz=False)[0]
    dt, de, dg = (depth_to_dist(d, Ks) for d in (depth, d_est, d_gt))
    return (_visib_mask_bop19(dt, dg, delta) | _visib_mask_bop19(dt, de, delta)).sum(dim=(1, 2))


def phase_score(card, scene, bank, tmp):
    """The BOP scorer on the card over the RGB-D scene."""
    from gdrnpp_bop2022_torch.eval.scorer import VSD_TAUS, score_bop_results
    from gdrnpp_bop2022_torch.eval.vsd import vsd_batch_bbox, vsd_batch_full, vsd_bbox_plan
    from gdrnpp_bop2022_torch.ops.raster import pack_faces_cuda, render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch

    gts, depths, area = _scene_poses(scene, bank)
    K = scene["K"]
    getter = lambda s, i: depths.get((s, i))                                 # noqa: E731
    plain = lambda *a, need_xyz=True: render_depth_xyz_batch(                # noqa: E731
        *a, need_xyz=need_xyz, max_block=PLAIN_MAX_BLOCK)
    kw = dict(im_width=640, depth_test_getter=getter, vsd_mode="full")
    ar_keys = ("AR", "AR_vsd", "AR_mssd", "AR_mspd")
    n_vis = sum(g["visib_fract"] >= 0.1 for g in gts)

    stats = {}
    render_depth_xyz_cuda.launches = pack_faces_cuda.launches = 0   # count this path only
    s_gt = score_bop_results(_estimates(gts, K), gts, bank, device="cuda", stats=stats, **kw)
    launches = render_depth_xyz_cuda.launches
    check(launches > 0 and pack_faces_cuda.launches == launches,
          f"scoring: {launches} raster / {pack_faces_cuda.launches} pack launches")
    check(all(s_gt[k] == 1.0 for k in ar_keys),
          f"GT poses as estimates: {({k: s_gt[k] for k in ar_keys})}")
    sec = ", ".join(f"{k} {v:.3f} s" for k, v in stats["seconds"].items())
    log(f"[8/18] scoring GT poses as estimates ({len(gts)} GT, {n_vis} at visib >= 0.1, "
        f"{stats['n_targets']} targets, {stats['n_pairs']} pairs) on the card, "
        f"vsd_mode=full: AR = AR_vsd = AR_mssd = AR_mspd = 1.0; VSD pairs per render "
        f"{stats['vsd_pairs']}; {launches} B2 calls; {sec}; "
        f"{stats['targets_per_s']:.1f} targets/s  [{card}]")

    cpu_im = min(area, key=area.get)        # the image of smallest VSD windows
    sub = [g for g in gts if g["im_id"] == cpu_im]
    ladder = []
    for name, dt, deg in LADDER:
        ests = _estimates(gts, K, dt, deg)
        st = {}
        s_b2 = score_bop_results(ests, gts, bank, device="cuda", stats=st, **kw)
        t0 = time.perf_counter()
        s_pl = score_bop_results(ests, gts, bank, device="cuda", render=plain, **kw)
        plain_s = time.perf_counter() - t0
        check(s_b2 == s_pl, f"ladder {name}: B2 {s_b2} != plain rasterizer {s_pl}")
        check(s_b2["AR"] < 1.0, f"ladder {name}: AR {s_b2['AR']} is not below 1")
        e_sub = _estimates(sub, K, dt, deg)
        s_card = score_bop_results(e_sub, sub, bank, device="cuda", **kw)
        t0 = time.perf_counter()
        s_cpu = score_bop_results(e_sub, sub, bank, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        gap = max(abs(s_card[k] - s_cpu[k]) for k in s_cpu)
        check(s_card.keys() == s_cpu.keys() and gap <= SCORE_CPU_TOL,
              f"ladder {name}: card vs CPU gap {gap} on image {cpu_im}")
        ladder.append({"rung": name, **{k: s_b2[k] for k in ar_keys},
                       "seconds": st["seconds"]["total"]})
        log(f"[8/18] ladder {name}: " + " ".join(f"{k}={s_b2[k]:.4f}" for k in ar_keys)
            + f" (B2 == plain rasterizer on the card, every key; image {cpu_im}'s "
            f"{len(sub)} GT on the card vs the CPU: max gap {gap:.2e}); "
            f"{st['seconds']['total']:.3f} s, {st['targets_per_s']:.1f} targets/s; with the "
            f"plain rasterizer on the card {plain_s:.1f} s; image {cpu_im} on the CPU "
            f"{cpu_s:.1f} s  [{card}]")

    # bbox VSD == full-image VSD per pair on the card, where the plan fits
    ests = _estimates(gts, K, *LADDER[-1][1:])
    dev = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")   # noqa: E731
    lab = np.array([bank.obj_ids.index(g["obj_id"]) for g in gts])
    radii = np.linalg.norm(bank.verts.astype(np.float64), axis=-1).max(1)[lab]
    te, tg = np.stack([e["t"] for e in ests]), np.stack([g["t"] for g in gts])
    bucket, offs, buckets = vsd_bbox_plan(te, tg, np.tile(K, (len(gts), 1, 1)), radii, 480, 640)
    d_all = np.stack([depths[(g["scene_id"], g["im_id"])] for g in gts])
    taus = dev(VSD_TAUS)
    n_fit = n_eq = 0
    worst = 0.0
    for bi, (bh, bw) in enumerate(buckets):
        for i0 in range(0, int((bucket == bi).sum()), 16):
            m = np.where(bucket == bi)[0][i0:i0 + 16]
            lm = torch.as_tensor(lab[m], device="cuda")
            common = (dev(bank.verts)[lm], torch.as_tensor(bank.faces, device="cuda")[lm],
                      dev(bank.diameters)[lm], taus)
            poses = (dev([ests[i]["R"] for i in m]), dev(te[m]), dev([gts[i]["R"] for i in m]),
                     dev(tg[m]))
            wins = dev([d_all[i, offs[i, 0]:offs[i, 0] + bh, offs[i, 1]:offs[i, 1] + bw]
                        for i in m])
            Ks = dev(np.tile(K, (len(m), 1, 1)))
            e_box = vsd_batch_bbox(*poses, wins, torch.as_tensor(offs[m], device="cuda"), Ks,
                                   *common)
            e_full = vsd_batch_full(*poses, dev(d_all[m]), Ks, *common)
            diff = (e_box - e_full).abs().amax(dim=1)
            share = 1.0 / _union_counts(*poses, dev(d_all[m]), Ks, *common[:2]).clamp_min(1)
            check(bool((diff <= share + 1e-6).all()), f"bbox VSD vs full VSD at {bh}x{bw}: "
                                               f"{diff.tolist()} > one pixel's share")
            n_fit += len(m)
            n_eq += int((diff == 0).sum())
            worst = max(worst, float((diff / share).max()))
    log(f"[8/18] bbox VSD vs full-image VSD on the card, {n_fit} pairs whose plan fits a "
        f"bucket (of {len(gts)}; ladder rung {LADDER[-1][0]}): {n_eq} equal, the rest within "
        f"one pixel's share of their union (worst {worst:.2f} of it): the window's principal "
        f"point, shifted by the integer origin, rounds u by <= 1 ulp  [{card}]")

    # the served RGB-D CSV through the port's score_csv CLI
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gdrnpp_bop2022_torch.tools.score_csv",
                           "--csv", os.path.join(tmp, "poses_rgbd.csv"), "--dataset", "ycbv",
                           "--root", tmp], capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    check(proc.returncode == 0, f"score_csv CLI failed: {proc.stderr[-2000:]}")
    cli = json.loads(proc.stdout)
    check(all(k in cli and np.isfinite(cli[k]) and 0.0 <= cli[k] <= 1.0 for k in ar_keys)
          and all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in cli.values()),
          f"score_csv CLI scores {cli}")
    log(f"[8/18] python -m gdrnpp_bop2022_torch.tools.score_csv on the served RGB-D CSV: "
        + " ".join(f"{k}={cli[k]:.4f}" for k in ar_keys)
        + f", {len(cli)} keys all finite in [0, 1]; {time.perf_counter() - t0:.1f} s "
        f"with the process start  [{card}]")
    return {"launches": launches, "stats": stats, "ladder": ladder}


# ---------------------------------------------------------------------------
# B1 backward and GDRN training
# ---------------------------------------------------------------------------

def _ln_bwd_case(rows, C, dtype, g, offset=0, stats_offset=None):
    """B1's backward (gdrnpp::layer_norm's autograd, as training calls it) vs its plain
    version (autograd through layer_norm_ref) on x, dy (rows, C) drawn from
    g; with stats_offset, layer_norm_backward called with the forward's mean
    and rstd copied into views that start that many rows into their
    buffers. Returns (max abs err of dx, of dweight / dbias relative to the
    sum of the absolute values of their terms, ok, vector path taken)."""
    from gdrnpp_bop2022_torch.ops.layer_norm import (_forward_cuda, _vector_path, layer_norm,
                                                     layer_norm_backward,
                                                     layer_norm_backward_ref)
    buf = (torch.randn(rows * C + offset, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dbuf = torch.randn(rows * C + offset, device="cuda", generator=g).to(dtype)
    x, dy = buf[offset:].view(rows, C), dbuf[offset:].view(rows, C)
    w = (1 + 0.1 * torch.randn(C, device="cuda", generator=g)).requires_grad_(True)
    b = (0.1 * torch.randn(C, device="cuda", generator=g)).requires_grad_(True)
    if stats_offset is None:
        xr = x.detach().clone().requires_grad_(True)
        layer_norm(xr, w, b).backward(dy)
        dx, dw, db = xr.grad, w.grad, b.grad
        vec = _vector_path(x, dy, w, x)
    else:
        _, mean, rstd = _forward_cuda(x, w.detach(), b.detach(), 1e-6, with_stats=True)
        views = []
        for st in (mean, rstd):
            sbuf = torch.full((rows + stats_offset,), float("nan"), device="cuda")
            sbuf[stats_offset:] = st
            views.append(sbuf[stats_offset:])
        dx, dw, db = layer_norm_backward(dy, x, w.detach(), *views)
        vec = _vector_path(x, dy, w, x, *views)
    dx_ref, dw_ref, db_ref = layer_norm_backward_ref(dy, x, w.detach())
    torch.cuda.synchronize()
    ref = dx_ref.float()
    err = (dx.float() - ref).abs()
    if dtype == torch.float32:
        ok = bool((err <= LN_TOL_F32).all())
    else:
        _, e = torch.frexp(ref)
        ok = bool((err <= torch.ldexp(torch.ones_like(ref), e - 8) + 1e-5).all())
    xf = x.float()
    xhat = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(
        xf.var(-1, unbiased=False, keepdim=True) + 1e-6)
    rel = 0.0
    for got, want, terms in ((dw, dw_ref, (dy.float() * xhat).abs().sum(0)),
                             (db, db_ref, dy.float().abs().sum(0))):
        rel = max(rel, float(((got - want).abs() / (terms + 1e-12)).max()))
    return float(err.max()), rel, ok and rel <= LN_BWD_REL_TOL, vec


def bwd_device_ms(fn):
    """Device time per call of fn(), one call of B1's backward, over the
    kernels whose names contain "layer_norm_bwd" (this design's and earlier
    ones' alike): of each such kernel, by its exact name, the mean of the
    records the profiler kept, times the launches of it that a call makes
    (the wrapper's reduce_launches for the reduction, its launches for the
    rows kernel), summed. A trace that kept no record of either is taken
    again, up to PROFILE_TRIES traces."""
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm_backward as lb
    before = (lb.launches, lb.reduce_launches)
    fn()
    per_call = {True: lb.reduce_launches - before[1], False: lb.launches - before[0]}
    for _ in range(PROFILE_TRIES):
        records = [e for e in _cuda_records(fn, 20) if "layer_norm_bwd" in e.key]
        kinds = [("reduce" in e.key) for e in records]
        if sorted(kinds) == [False, True]:
            break
        log(f"the profiler kept records of {[e.key for e in records]} of B1's backward, "
            f"not one rows kernel and one reduction; tracing again")
    check(sorted(kinds) == [False, True],
          f"B1 backward: no trace kept one rows kernel and one reduction: "
          f"{[e.key for e in records]}")
    return sum(_device_us(e) / e.count * per_call[k] for e, k in zip(records, kinds)) / 1e3


def ln_backward_times(card):
    """B1's backward at the training shapes (batch TRAIN_BATCH, bf16, 40
    LayerNorms): per width and per step, hot (profiler device time of the
    layer_norm_bwd* kernels) and cold ms beside the bytes bound, the rows
    kernel and the reduction apart (hot), the plain version's hot time,
    aten's native_layer_norm_backward (what autograd through F.layer_norm
    runs) hot, a copy_ of the same bytes cold; the forward with statistics
    cold (events: the profiler lost its events once at these 5-40 us calls),
    and its bound."""
    from gdrnpp_bop2022_torch.ops.layer_norm import (_forward_cuda, layer_norm_backward,
                                                     layer_norm_backward_ref)
    g = torch.Generator(device="cuda").manual_seed(SEED + 12)
    t = dict.fromkeys(("ms", "cold_ms", "plain_ms", "library_ms", "copy_cold_ms",
                       "fwd_stats_cold_ms"), 0.0)
    t["shapes"] = []
    n_bytes = fwd_bytes = 0
    for r, C, n in LN_SHAPES:
        rows = TRAIN_BATCH * r
        x = (torch.randn(rows, C, device="cuda", generator=g) * 2 + 0.5).to(torch.bfloat16)
        dy = torch.randn(rows, C, device="cuda", generator=g).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
        b = 0.1 * torch.randn(C, device="cuda", generator=g)
        _, mean, rstd = _forward_cuda(x, w, b, 1e-6, with_stats=True)
        fs = cold_ms(lambda: _forward_cuda(x, w, b, 1e-6, with_stats=True))
        bwd = lambda: layer_norm_backward(dy, x, w, mean, rstd)      # noqa: E731
        k = bwd_device_ms(bwd)
        kc = cold_ms(bwd)
        split = kernel_ms(bwd, LN_BWD_KERNELS, per_call=dict.fromkeys(LN_BWD_KERNELS, 1))
        p = device_ms(lambda: layer_norm_backward_ref(dy, x, w))
        wb, bb = w.bfloat16(), b.bfloat16()
        _, m_l, r_l = torch.ops.aten.native_layer_norm(x, [C], wb, bb, 1e-6)
        lib = device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [C], m_l, r_l, wb, bb, [True, True, True]))
        src = torch.empty(3 * x.numel() // 2, dtype=torch.bfloat16, device="cuda")
        dst = torch.empty_like(src)          # reads and writes 3 x x's bytes
        cp = cold_ms(lambda: dst.copy_(src))
        for key, v in zip(t, (k, kc, p, lib, cp, fs)):
            t[key] += n * v
        call_bytes = 3 * x.numel() * 2 + 2 * rows * 4 + 3 * C * 4
        bound = call_bytes / H100_BYTES_PER_S * 1e3
        n_bytes += n * call_bytes
        fwd_bytes += n * (2 * x.numel() * 2 + 2 * rows * 4 + 2 * C * 4)
        t["shapes"].append({"rows": rows, "C": C, "calls": n, "ms": k, "cold_ms": kc,
                            "bound_ms": bound, "kernels_ms": split, "copy_cold_ms": cp,
                            "library_ms": lib, "plain_ms": p})
        split_txt = ", ".join(f"{kn} {v:.4f}" for kn, v in split.items() if v)
        log(f"[10/18] B1 backward rows={rows} C={C} bfloat16 x{n}, a call: kernel hot {k:.4f} "
            f"ms, cold {kc:.4f} ms, bound {bound:.4f} ms ({100 * bound / kc:.1f}% of it cold, "
            f"{100 * bound / k:.1f}% hot); hot apart: {split_txt or 'not measured'} ms; copy_ "
            f"of the same bytes cold {cp:.4f} ms; native_layer_norm_backward hot {lib:.4f} "
            f"ms; plain {p:.4f} ms; forward with statistics cold {fs:.4f} ms  [{card}]")
    t["bound_ms"] = n_bytes / H100_BYTES_PER_S * 1e3
    t["fwd_stats_bound_ms"] = fwd_bytes / H100_BYTES_PER_S * 1e3
    log(f"[10/18] B1 backward per training step at batch {TRAIN_BATCH} (40 LayerNorms, "
        f"bf16): kernel hot {t['ms']:.4f} ms ({100 * t['bound_ms'] / t['ms']:.1f}% of the "
        f"bound), cold {t['cold_ms']:.4f} ms ({100 * t['bound_ms'] / t['cold_ms']:.1f}% of the "
        f"bound cold); plain {t['plain_ms']:.4f} ms; native_layer_norm_backward hot "
        f"{t['library_ms']:.4f} ms; copy_ of the same bytes cold {t['copy_cold_ms']:.4f} ms; "
        f"bound {t['bound_ms']:.4f} ms ({n_bytes / 1e9:.3f} GB at 3.35 TB/s). Forward with "
        f"statistics cold {t['fwd_stats_cold_ms']:.4f} ms, bound {t['fwd_stats_bound_ms']:.4f} "
        f"ms ({fwd_bytes / 1e9:.3f} GB)  [{card}]")
    return t


def _ln_bwd_repeat(g, calls=LN_BWD_REPEAT):
    """`calls` backward calls in a row at (TRAIN_BATCH x 256, 512) bf16 on the
    same inputs, each with its own scratch: True if every call gives the
    first call's bits."""
    from gdrnpp_bop2022_torch.ops.layer_norm import _forward_cuda, layer_norm_backward
    rows, C = TRAIN_BATCH * 256, 512
    x = (torch.randn(rows, C, device="cuda", generator=g) * 2 + 0.5).to(torch.bfloat16)
    dy = torch.randn(rows, C, device="cuda", generator=g).to(torch.bfloat16)
    w = 1 + 0.1 * torch.randn(C, device="cuda", generator=g)
    _, mean, rstd = _forward_cuda(x, w, torch.zeros_like(w), 1e-6, with_stats=True)
    first = layer_norm_backward(dy, x, w, mean, rstd)
    same = True
    for _ in range(calls - 1):
        out = layer_norm_backward(dy, x, w, mean, rstd)
        same &= all(torch.equal(a, b) for a, b in zip(out, first))
    torch.cuda.synchronize()
    return same


def phase_ln_backward(card):
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    worst = 0.0
    both = (torch.bfloat16, torch.float32)
    cases = [(TRAIN_BATCH * r, C, dt, 0, None) for r, C, _ in LN_SHAPES for dt in both]
    # the vector backward's edges: a tile of 1 or 3 rows, a ragged last tile
    cases += [(r, C, dt, 0, None) for r, C in LN_BWD_EDGES for dt in both]
    # mean and rstd as views at an odd row (scalar path) and 4 rows in (vector)
    cases += [(TRAIN_BATCH * 256 + 5, 512, torch.bfloat16, 0, so) for so in LN_BWD_STATS_OFFSETS]
    # the scalar path: C = 100 in bf16, inputs offset by one element
    cases += [(r, C, dt, off, None) for r, C, off in ((4099, 100, 0), (TRAIN_BATCH * 4096, 128, 1),
                                                      (777, 1024, 1)) for dt in both]
    for rows, C, dt, off, so in cases:
        err, rel, ok, vec = _ln_bwd_case(rows, C, dt, g, off, so)
        worst = max(worst, err)
        log(f"[10/18] B1 backward rows={rows} C={C} {str(dt)[6:]} offset={off}"
            f"{'' if so is None else f' stats offset={so}'} {'vector' if vec else 'scalar'} "
            f"path: dx max_abs_err={err:.3g}, dweight/dbias max err / sum|terms| = {rel:.3g}")
        check(ok, f"B1 backward disagrees with its plain version at rows={rows} C={C} {dt} "
                  f"offset {off} stats offset {so}: dx err {err}, dweight/dbias rel {rel}")
        check(so is None or vec == (so % 4 == 0),
              f"B1 backward: mean / rstd {so} rows in took the wrong path")
    check(_ln_bwd_repeat(g), f"B1 backward: {LN_BWD_REPEAT} calls in a row gave different bits")
    log(f"[10/18] B1 backward: {LN_BWD_REPEAT} calls in a row at ({TRAIN_BATCH * 256}, 512) "
        f"bf16 gave the same bits")
    t = ln_backward_times(card)
    t["max_abs_err"] = worst
    t["bound_by"] = "bytes"
    log(f"[10/18] B1 backward checked and timed in {time.perf_counter() - t0:.1f} s  [{card}]")
    return t


def make_train_split(root, axes_mm, rs, n_images=TRAIN_IMAGES):
    """A BOP train split <root>/train_pbr/000000: n_images 480x640 RGB PNGs
    with DETS_PER_IMAGE ellipsoids each, their analytic depth (depth/,
    0.1 mm units), their amodal (mask/) and visible (mask_visib/) masks as
    PNGs from the analytic ray hits, and scene_gt / scene_gt_info /
    scene_camera (YCB-V's camera)."""
    import cv2
    from gdrnpp_bop2022_torch.bop.inout import save_json
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    K = get_meta("ycbv").camera_matrix.astype(np.float64)
    sdir = os.path.join(root, "train_pbr", "000000")
    for sub in ("rgb", "depth", "mask", "mask_visib"):
        os.makedirs(os.path.join(sdir, sub))
    H, W = 480, 640
    gt, info, cam = {}, {}, {}
    yy, xx = np.mgrid[0:H, 0:W]
    for im in range(n_images):
        depth, shade, objs = np.zeros((H, W)), np.zeros((H, W)), []
        for o in rs.choice(np.arange(1, 22), DETS_PER_IMAGE, replace=False):
            ax = axes_mm[o - 1] * 1e-3
            R = random_rotation(rs)
            z = rs.uniform(0.7, 1.3)
            u, v = rs.uniform(90, W - 90), rs.uniform(90, H - 90)
            t = z * pixel_rays(K, np.array([u]), np.array([v]))[0]
            r = int(K[0, 0] * ax.max() / (z - ax.max())) + 2
            x0, x1 = max(int(u) - r, 0), min(int(u) + r + 1, W)
            y0, y1 = max(int(v) - r, 0), min(int(v) + r + 1, H)
            d, _ = ellipsoid_hits(pixel_rays(K, xx[y0:y1, x0:x1].ravel().astype(float),
                                             yy[y0:y1, x0:x1].ravel().astype(float)), R, t, ax)
            d = d.reshape(y1 - y0, x1 - x0)
            win = depth[y0:y1, x0:x1]
            front = (d > 0) & ((win == 0) | (d < win))
            win[front] = d[front]
            shade[y0:y1, x0:x1][front] = 60 + 9 * o
            objs.append((int(o), R, t, y0, x0, d))
        gt[str(im)], info[str(im)] = [], []
        for inst, (o, R, t, y0, x0, d) in enumerate(objs):
            full = np.zeros((H, W), np.uint8)
            full[y0:y0 + d.shape[0], x0:x0 + d.shape[1]] = (d > 0) * 255
            vis = full * (depth == np.pad(d, ((y0, H - y0 - d.shape[0]),
                                              (x0, W - x0 - d.shape[1]))))
            cv2.imwrite(os.path.join(sdir, "mask", f"{im:06d}_{inst:06d}.png"), full)
            cv2.imwrite(os.path.join(sdir, "mask_visib", f"{im:06d}_{inst:06d}.png"),
                        vis.astype(np.uint8))
            ys, xs = np.nonzero(full)
            box = [int(xs.min()), int(ys.min()), int(xs.max() - xs.min() + 1),
                   int(ys.max() - ys.min() + 1)]
            vy, vx = np.nonzero(vis)
            vbox = ([int(vx.min()), int(vy.min()), int(vx.max() - vx.min() + 1),
                     int(vy.max() - vy.min() + 1)] if len(vx) else [0, 0, 0, 0])
            gt[str(im)].append({"obj_id": o, "cam_R_m2c": R.ravel().tolist(),
                                "cam_t_m2c": (t * 1000).tolist()})
            info[str(im)].append({"bbox_obj": box, "bbox_visib": vbox,
                                  "visib_fract": float(len(vx) / len(xs))})
        img = (np.stack([shade + xx * 0.1, shade * 0.8 + yy * 0.1, shade * 0.6], -1)
               + rs.randint(0, 30, (H, W, 3))) % 256
        cv2.imwrite(os.path.join(sdir, "rgb", f"{im:06d}.png"), img.astype(np.uint8))
        cv2.imwrite(os.path.join(sdir, "depth", f"{im:06d}.png"),
                    np.round(depth * 10000).astype(np.uint16))
        cam[str(im)] = {"cam_K": K.ravel().tolist(), "depth_scale": 0.1}
    save_json(os.path.join(sdir, "scene_gt.json"), gt)
    save_json(os.path.join(sdir, "scene_gt_info.json"), info)
    save_json(os.path.join(sdir, "scene_camera.json"), cam)


def write_backgrounds(bg_dir, rs, n=TRAIN_BG_IMAGES):
    """n 640x480 background PNGs: per channel a random level and gradient,
    plus noise."""
    import cv2
    os.makedirs(bg_dir)
    yy, xx = np.mgrid[0:480, 0:640]
    for i in range(n):
        level, gx, gy = rs.uniform(0, 255, 3), rs.uniform(-0.3, 0.3, 3), rs.uniform(-0.3, 0.3, 3)
        img = level + gx * xx[..., None] + gy * yy[..., None] + rs.randint(0, 40, (480, 640, 3))
        cv2.imwrite(os.path.join(bg_dir, f"bg_{i:03d}.png"), np.clip(img, 0, 255).astype(np.uint8))
    return sorted(os.path.join(bg_dir, f) for f in os.listdir(bg_dir))


def _aug_check(card, cfg, records, meta, bg_paths):
    """Background replacement and colour augmentation of one training batch
    on the card, with draws from a generator on the card, against their
    plain versions on the CPU given the same draws; and their time on the
    card (CUDA events, draws included)."""
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.ops.color_aug import (apply_color_aug, draw_color_aug,
                                                    draw_replace_background,
                                                    replace_background)
    inp = cfg.input
    loader = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, seed=SEED + 7,
                             bg_paths=bg_paths, truncate_fg=inp.truncate_fg)
    try:
        hb = next(loader)
    finally:
        loader.close()
    images, fg, bgs = (torch.as_tensor(hb[k]).cuda() for k in ("images", "fg_masks",
                                                                  "bg_images"))
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    aug_type = inp.color_aug.aug_type

    def augment():
        bd = draw_replace_background(g, TRAIN_BATCH, TRAIN_BATCH, inp.change_bg_prob)
        x, gate = replace_background(images.float(), fg, bgs, bd)
        cd = draw_color_aug(g, tuple(x.shape), aug_type, inp.color_aug.prob)
        return bd, x, gate, cd, apply_color_aug(x, cd, aug_type)

    bd, x, gate, cd, out = augment()
    n = AUG_CPU_SAMPLES
    cut = lambda d: {k: v[:n].cpu() for k, v in d.items()}         # noqa: E731
    x_cpu, gate_cpu = replace_background(images[:n].float().cpu(), fg[:n].cpu(), bgs.cpu(),
                                         cut(bd))
    bg_exact = bool(torch.equal(x_cpu, x[:n].cpu()) and torch.equal(gate_cpu, gate[:n].cpu()))
    err = float((apply_color_aug(x[:n].cpu(), cut(cd), aug_type) - out[:n].cpu()).abs().max())
    check(bg_exact and err <= AUG_TOL and 0 < float(gate.sum()) < TRAIN_BATCH,
          f"augmentation card vs CPU: background exact {bg_exact}, colour max err {err}")
    ms = cuda_ms(lambda: augment(), iters=5, warmup=1)
    log(f"[10/18] background replacement (p {inp.change_bg_prob}, {len(bg_paths)} images) and "
        f"{aug_type} colour augmentation (p {inp.color_aug.prob}) of a training batch "
        f"({TRAIN_BATCH} x 480x640) on the card vs their plain versions on the CPU, same "
        f"draws, first {n} images: background bit for bit ({int(gate.sum())} of "
        f"{TRAIN_BATCH} replaced), colour max abs err {err:.2e} on [0, 255] (limit "
        f"{AUG_TOL}); draws + both on the card {ms:.2f} ms  [{card}]")
    return {"max_abs_err": err, "ms": ms}


def _train_b2(card, records, bank, meta):
    """B2 in attribute mode at one training batch's render (TRAIN_BATCH ROIs
    x 64^2 x the decimated bank) vs plain, and its times."""
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.geometry.camera import centered_crop_K
    from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.ops.rasterizer import render_depth_xyz_batch
    loader = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, seed=SEED,
                             num_workers=1)
    try:
        hb = next(loader)
    finally:
        loader.close()
    dev = lambda k: torch.as_tensor(hb[k]).cuda()        # noqa: E731
    lab = dev("labels").long()
    inp = (torch.as_tensor(bank.verts).cuda()[lab], torch.as_tensor(bank.faces).cuda()[lab],
           dev("gt_rots"), dev("gt_transes"),
           centered_crop_K(dev("Ks"), dev("centers"), dev("scales"), 64), 64, 64)
    F = inp[1].shape[1]
    err = _raster_case(f"training batch B={TRAIN_BATCH} 64x64 F={F}", *inp, tag="[10/18]")
    call = lambda: render_depth_xyz_cuda(*inp)                      # noqa: E731
    bd = raster_bound(*inp)
    # hot by the profiler: events around back-to-back calls of ~40 us time
    # the host's enqueue
    t = {"ms": device_ms(call, kernels=B2_KERNELS), "cold_ms": cold_ms(call),
         "plain_ms": cuda_ms(lambda: render_depth_xyz_batch(*inp, max_block=PLAIN_MAX_BLOCK),
                             iters=3, warmup=1),
         "bound_ms": bd["bound_ms"], "max_abs_err": err, "faces": F}
    log(f"[10/18] B2 attribute mode at the training batch ({TRAIN_BATCH} ROIs x 64^2 x {F} "
        f"faces, decimated): hot {t['ms']:.4f} ms, cold {t['cold_ms']:.4f} ms, plain "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({bd['pairs']:.4e} pixel-face "
        f"pairs in the boxes, {bd['bound_by']}); faces per tile mean "
        f"{float(bd['per_tile'].float().mean()):.1f}  [{card}]")
    return t


def _train_parity(card, records, bank, meta, over=None, tag="[10/18]"):
    """One fp32 step of the tiny config (with ``over``: the dual stream) on
    the card and on the CPU from the same weights and batch (built once on
    the CPU): losses, grads and the params after the step."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.train_step import (forward_outputs, loss_and_metrics,
                                                        make_train_step)
    from gdrnpp_bop2022_torch.engine.trainer import device_bank, prep_train_batch
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.solver.lr_scheduler import build_lr_scheduler
    from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
    cfg = replace_cfg(Config(), dict(TRAIN_TINY, **(over or {})))
    loader = GdrnTrainLoader(records, 4, meta.width, meta.height, seed=SEED + 1, num_workers=1,
                             with_depth=cfg.input.with_depth)
    try:
        hb = next(loader)
    finally:
        loader.close()
    R = cfg.model.pose_net.geo_head.num_regions
    batch_cpu = prep_train_batch(hb, device_bank(bank, R, "cpu"), cfg, "cpu")
    res = {}
    # the dual stream: the card twice, for its own run-to-run spread
    for run in (("cuda", "cuda2", "cpu") if over else ("cuda", "cpu")):
        dev = run[:4]
        bnk = device_bank(bank, R, dev)
        batch = {k: v.to(dev) for k, v in batch_cpu.items()}
        model = build_gdrn(cfg, device=dev, train=True)
        model.load_state_dict(seeded_state_dict(model, SEED + 9), strict=True)
        total, _ = loss_and_metrics(cfg, forward_outputs(model, batch), batch,
                                    bnk["sym_bank"], bnk["sym_mask"])
        total.backward()
        grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
        state = create_train_state(model, build_optimizer(cfg, build_lr_scheduler(cfg, 10),
                                                          model))
        metrics = make_train_step(cfg, bnk["sym_bank"], bnk["sym_mask"])(state, batch)
        res[run] = ({k: float(v) for k, v in metrics.items()}, grads,
                    {n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, state
    (mg, gg, pg), (mc, gc, pcpu) = res["cuda"], res["cpu"]
    loss_err = max(abs(mg[k] - mc[k]) / max(abs(mc[k]), 1.0) for k in mc)
    rel = lambda a, b: max(float((a[n] - b[n]).abs().max())            # noqa: E731
                           / max(float(b[n].abs().max()), 1e-12) for n in b)
    grad_err = rel(gg, gc)
    if over:
        # the dual stream: Ranger's first step moves a tensor by lr x its
        # centralized gradient plus the same weight decay on both, so the
        # params may differ by lr x the grads' difference, centralization
        # at most doubling it: held per tensor against lr x max|grad|
        lr = build_lr_scheduler(cfg, 10)(0)
        par_err = max(float((pg[n] - pcpu[n]).abs().max())
                      / (TRAIN_PARITY_GRAD_TOL * 2.0 * lr * float(gc[n].abs().max())
                         + 2.0 ** -22 * float(pcpu[n].abs().max()) + 1e-30) for n in pcpu)
        par_tol = 1.0
        par_what = ("params after the step over (grads' limit x 2 lr max|grad| + two fp32 "
                    "ulps of max|param|), per tensor")
    else:
        par_err, par_tol, par_what = rel(pg, pcpu), TRAIN_PARITY_PARAM_TOL, "params after the step"
    worst = sorted(((float((gg[n] - gc[n]).abs().max()) / max(float(gc[n].abs().max()), 1e-12),
                     n) for n in gc), reverse=True)[:3]
    spread = f"; the card's own run-to-run grads {rel(res['cuda2'][1], gg):.2e}" if over else ""
    log(f"{tag} tiny step card vs CPU, the grads' worst tensors: "
        + ", ".join(f"{n} {e:.2e}" for e, n in worst) + spread)
    check(loss_err <= TRAIN_PARITY_LOSS_TOL and grad_err <= TRAIN_PARITY_GRAD_TOL
          and par_err <= par_tol,
          f"training step card vs CPU: losses {loss_err}, grads {grad_err}, params {par_err}")
    log(f"{tag} one fp32 training step of the tiny config (convnext_tiny 64->16, 21 "
        f"classes, batch 4, Ranger at {cfg.solver.base_lr}{', dual stream' if over else ''}), "
        f"card (B1 forward and backward "
        f"kernels) vs CPU (plain), TF32 off, same weights and batch: losses max rel diff "
        f"{loss_err:.2e} (limit {TRAIN_PARITY_LOSS_TOL}), grads max diff / max|grad| per "
        f"tensor {grad_err:.2e} (limit {TRAIN_PARITY_GRAD_TOL}), {par_what} "
        f"{par_err:.2e} (limit {par_tol})")


def _train_profile(card, cfg, state, records, bank, meta, bg_paths, tag="[10/18]"):
    """Where a training step's device time goes: torch.profiler over
    TRAIN_PROFILE_STEPS steps (host prep of one loader batch included, with
    its augmentations, the loader's wait not): kernel time by name, and the
    device's busy share of the steps' wall time."""
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.engine.train_step import make_train_step
    from gdrnpp_bop2022_torch.engine.trainer import (device_bank, make_generators,
                                                     prep_train_batch)
    from gdrnpp_bop2022_torch.models.layers import DropMasks
    loader = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, seed=SEED + 3,
                             bg_paths=bg_paths, truncate_fg=cfg.input.truncate_fg,
                             with_depth=cfg.input.with_depth)
    try:
        hb = next(loader)
    finally:
        loader.close()
    bnk = device_bank(bank, cfg.model.pose_net.geo_head.num_regions, "cuda")
    step = make_train_step(cfg, bnk["sym_bank"], bnk["sym_mask"])
    gens = make_generators(SEED + 3, "cuda")
    drop = DropMasks(gen=gens["dropout"])
    wall_ms, busy, n_k, ev = profile_calls(
        lambda: step(state, prep_train_batch(hb, bnk, cfg, "cuda", gens=gens), drop=drop),
        TRAIN_PROFILE_STEPS)
    log(f"{tag} profiled training step at batch {TRAIN_BATCH} ({TRAIN_PROFILE_STEPS} steps, "
        f"host prep and augmentations included): {wall_ms:.2f} ms wall, {busy:.2f} ms of "
        f"device time "
        f"({100 * busy / wall_ms:.1f}% busy), {n_k} kernels and copies; "
        f"top (ms per step, count): " + "; ".join(
            f"{k[:70]} {ms:.2f} ({c})" for k, ms, c in ev[:TRAIN_PROFILE_TOP]) + f"  [{card}]")
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "top": [(k[:70], ms, c) for k, ms, c in ev[:TRAIN_PROFILE_TOP]]}


def _trainable_loss(cfg, model, batch, bnk):
    """(total_loss, total_loss less the region CE's closed-form constant) of
    `model` on `batch`, no gradient. The constant is what _masked_sum_ce adds
    for the pixels outside the mask: region_lw x (pixels - n_mask) x
    log(R + 1) / n_mask; the remainder is the sum of every trainable term."""
    from gdrnpp_bop2022_torch.engine.train_step import forward_outputs, loss_and_metrics
    lc = cfg.model.pose_net.loss
    check(lc.xyz_loss_type == "L1", "CE_coor xyz adds a constant of its own")
    with torch.no_grad():
        out = forward_outputs(model, batch)
        total, _ = loss_and_metrics(cfg, out, batch, bnk["sym_bank"], bnk["sym_mask"])
        m = batch[f"gt_mask_{lc.region_loss_mask_gt}"].float()
        n = m.sum()
        const = (lc.region_lw * (m.numel() - n) * math.log(out["region"].shape[-1])
                 / n.clamp_min(1.0))
    return float(total), float(total - const)


class no_tf32:
    """TF32 off for the convolutions and matmuls inside the block (fp32
    comparisons with the CPU), the earlier settings back after it."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def _train_recipe(card, cfg, ctx, steps, loss_drop, tag, ln_per_step):
    """Train ``cfg`` for ``steps`` steps through train_gdrn on the card and
    check it: launches per step (B1 ln_per_step forward + backward +
    reductions, B2 1 pack + 1 raster), on a batch held apart the trainable
    loss below ``loss_drop`` x its value at the initial weights, EMA !=
    params, the last checkpoint restored bit for bit; log the step time
    split and profile three steps. Returns the run's numbers."""
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.trainer import device_bank, prep_train_batch, train_gdrn
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_backward
    from gdrnpp_bop2022_torch.ops.raster import pack_faces_cuda, render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
    pc, meta, records, bank = cfg.model.pose_net, ctx["meta"], ctx["records"], ctx["bank"]
    # the batch the loss criterion reads (its own loader seed, no
    # augmentation), and the initial weights' loss on it (train_gdrn seeds
    # torch with cfg.train.seed before it builds the model)
    loader = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, seed=SEED + 5,
                             num_workers=1, with_depth=cfg.input.with_depth)
    try:
        held_host = next(loader)
    finally:
        loader.close()
    bnk = device_bank(bank, pc.geo_head.num_regions, "cuda")
    held = prep_train_batch(held_host, bnk, cfg, "cuda")
    torch.manual_seed(cfg.train.seed)
    model0 = build_gdrn(cfg, train=True)
    held_total0, held_train0 = _trainable_loss(cfg, model0, held, bnk)
    del model0

    # the recipe through train_gdrn; counts from this run only
    stats = {}
    layer_norm.launches = layer_norm_backward.launches = 0
    layer_norm_backward.reduce_launches = layer_norm_backward.dy_copies = 0
    render_depth_xyz_cuda.launches = pack_faces_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_gdrn(cfg, records, bank, max_iters=steps, resume=False, meta=meta,
                       stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = steps
    launches = {"fwd": layer_norm.launches, "bwd": layer_norm_backward.launches,
                "reduce": layer_norm_backward.reduce_launches,
                "raster": render_depth_xyz_cuda.launches, "pack": pack_faces_cuda.launches}
    check(state.step == n and next(state.model.parameters()).is_cuda, "training did not run")
    check(launches["fwd"] == ln_per_step * n and launches["bwd"] == ln_per_step * n
          and launches["reduce"] == ln_per_step * n, f"B1 launches over {n} steps: {launches}")
    check(launches["raster"] == n and launches["pack"] == n, f"B2 launches: {launches}")
    out = cfg.output_dir
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.json"))]
    losses = [r["total_loss"] for r in rows]
    pose = [sum(r[k] for k in POSE_LOSSES) for r in rows]
    held_total, held_train = _trainable_loss(cfg, state.model, held, bnk)
    del held, held_host
    check(all(np.isfinite(losses)) and np.isfinite(held_train)
          and held_train < loss_drop * held_train0,
          f"the trainable loss on the held batch did not fall: {held_train0} at the initial "
          f"weights, {held_train} after {n} steps")
    check(any(not torch.equal(e, p) for e, p in zip(state.ema, state.model.parameters())),
          "the EMA weights equal the parameters")
    steps_ms = stats["step"][TRAIN_SKIP:]
    pct = lambda a, q: float(np.percentile(a, q))            # noqa: E731
    mean = lambda k: float(np.mean(stats[k][TRAIN_SKIP:]))   # noqa: E731
    rois_s = TRAIN_BATCH * len(steps_ms) / (sum(steps_ms) / 1e3)
    inp = cfg.input
    log(f"{tag} trained {cfg.exp_name} (convnext_base 256->64, 21 classes, bf16, batch "
        f"{TRAIN_BATCH}, Ranger 8e-4, flat-and-anneal with a {TRAIN_WARMUP}-step warmup, "
        f"colour aug {inp.color_aug.aug_type} at p {inp.color_aug.prob}, backgrounds at p "
        f"{inp.change_bg_prob}, depth aug {inp.with_depth and inp.depth_aug}, "
        f"train.cache_gb=0) for {n} steps through train_gdrn in {wall:.1f} s: on a batch of "
        f"{TRAIN_BATCH} held apart, total_loss less the region CE's constant (every trainable "
        f"term) {held_train0:.4f} at the initial weights -> {held_train:.4f} after {n} steps "
        f"({held_train / held_train0:.3f}x, must fall below {loss_drop}x; total_loss "
        f"{held_total0:.4f} -> {held_total:.4f}); logged every {TRAIN_LOG_PERIOD} steps: pose "
        f"losses ({' + '.join(POSE_LOSSES)}) " + " ".join(f"{v:.3f}" for v in pose)
        + "; total_loss " + " ".join(f"{v:.3f}" for v in losses))
    log(f"{tag} loss terms at the first and the last logged step: " + ", ".join(
        f"{k} {rows[0][k]:.4f} -> {rows[-1][k]:.4f}" for k in rows[0]
        if k.startswith("loss_") or k.startswith("error_")))
    split = {k: mean(k) for k in ("h2d", "aug", "batch", "depth", "fwd_bwd", "opt_ema")
             if k in stats}
    log(f"{tag} training step at batch {TRAIN_BATCH} (CUDA events, steps {TRAIN_SKIP + 1}.."
        f"{n - 1}): p50 {pct(steps_ms, 50):.2f} ms, p99 {pct(steps_ms, 99):.2f} ms = "
        f"{rois_s:.1f} ROIs/s; per step mean: H2D + pool gathers {split['h2d']:.2f} ms, "
        f"augmentations (background + colour) {split['aug']:.2f} ms, online batch (crops + B2 "
        f"+ targets) {split['batch']:.2f} ms, "
        + (f"depth aug + depth ROIs {split['depth']:.2f} ms, " if "depth" in split else "")
        + f"forward + backward {split['fwd_bwd']:.2f} ms, optimizer + EMA "
        f"{split['opt_ema']:.2f} ms; host wait on the loader mean "
        f"{float(np.mean(stats['host_wait'][TRAIN_SKIP:])):.2f} ms, p99 "
        f"{pct(stats['host_wait'][TRAIN_SKIP:], 99):.2f} ms; peak max_memory_allocated "
        f"{peak_gb:.2f} GB  [{card}]")
    log(f"{tag} launches per step: B1 forward {launches['fwd'] // n}, B1 backward "
        f"{launches['bwd'] // n} (+ {launches['reduce'] // n} reduction launches), B2 "
        f"{launches['pack'] // n} pack + {launches['raster'] // n} raster; dy copied before "
        f"the backward kernel {layer_norm_backward.dy_copies} times in {n} steps")

    # the last step's checkpoint, restored into a fresh state on the card
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    check(mgr.latest_step() == n, f"checkpoint steps: {mgr.latest_step()}")
    model = build_gdrn(cfg, train=True)
    fresh = create_train_state(model, build_optimizer(cfg, 1e-3, model))
    fresh.generators = {k: torch.Generator(device="cuda") for k in state.generators}
    mgr.restore_latest(fresh)
    same = (fresh.step == n
            and all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                      fresh.model.parameters()))
            and all(torch.equal(a, b) for a, b in zip(state.ema, fresh.ema))
            and all(torch.equal(v, fresh.optimizer.state[q][k])
                    for p, q in zip(state.model.parameters(), fresh.model.parameters())
                    for k, v in state.optimizer.state[p].items())
            and all(torch.equal(g.get_state(), fresh.generators[k].get_state())
                    for k, g in state.generators.items()))
    check(same, "the checkpoint did not restore params, EMA, optimizer state and generators "
          "bit for bit")
    size_gb = os.path.getsize(mgr.path(n)) / 1e9
    log(f"{tag} checkpoint of step {n} ({size_gb:.2f} GB: model, EMA, Ranger state, the "
        f"trainer's generators) restored on the card: params, EMA, optimizer state and "
        f"generators bit for bit")
    del fresh, model
    prof = _train_profile(card, cfg, state, records, bank, meta, ctx["bg_paths"], tag=tag)
    del state
    torch.cuda.empty_cache()
    return {"launches": launches, "profile": prof, "step_p50_ms": pct(steps_ms, 50),
            "step_p99_ms": pct(steps_ms, 99), "rois_s": rois_s, "peak_gb": peak_gb,
            "split_ms": split, "loss_ratio": held_train / held_train0}


def phase_train(card, scene, tmp):
    """GDRN training on the card: the synthetic train split and the
    backgrounds, the B1 backward check, B2's attribute mode at a training
    batch, the augmentations card vs CPU, the flagship recipe as configured
    for TRAIN_STEPS steps through train_gdrn and its checkpoint, card vs CPU
    on one tiny step. Returns what phase 11 and the pool run reuse."""
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base
    from gdrnpp_bop2022_torch.tools.train_gdrn import records_for

    lnb = phase_ln_backward(card)
    root = os.path.dirname(scene["models_dir"])             # <tmp>/ycbv
    t0 = time.perf_counter()
    make_train_split(root, scene["axes_mm"], np.random.RandomState(SEED + 30))
    bg_dir = os.path.join(tmp, "backgrounds")
    bg_paths = write_backgrounds(bg_dir, np.random.RandomState(SEED + 31))
    common = [f"datasets.root={os.path.dirname(root)!r}", "datasets.train2=()",
              f"solver.warmup_iters={TRAIN_WARMUP}", f"train.log_period={TRAIN_LOG_PERIOD}",
              "train.cache_gb=0", "solver.checkpoint_period_epochs=1000",
              f"input.bg_images_dir={bg_dir!r}"]
    cfg = replace_cfg(ycbv_convnext_base(), parse_opts(
        common + [f"output_dir={os.path.join(tmp, 'train_out')!r}"]))
    pc, meta = cfg.model.pose_net, scene["meta"]
    check(pc.backbone.name == "convnext_base" and pc.num_classes == 21 and pc.input_res == 256
          and cfg.solver.ims_per_batch == TRAIN_BATCH and cfg.solver.optimizer == "ranger"
          and cfg.model.compute_dtype == "bfloat16" and pc.xyz_online and pc.xyz_bp
          and cfg.input.color_aug.prob == 0.8 and cfg.input.color_aug.aug_type == "cosy+aae"
          and cfg.input.change_bg_prob == 0.5,
          "ycbv_convnext_base() is not the flagship training recipe")
    bank = ModelBank.from_bop_models_dir(scene["models_dir"], num_fps=pc.geo_head.num_regions,
                                         max_faces=pc.gt_max_faces)
    records = records_for(cfg, meta, cfg.datasets.train)
    check(bank.faces.shape[1] <= pc.gt_max_faces and len(records) >= TRAIN_BATCH,
          f"bank faces {bank.faces.shape}, {len(records)} records")
    log(f"[10/18] train split: {TRAIN_IMAGES} 480x640 images x {DETS_PER_IMAGE} ellipsoids, "
        f"analytic depth, mask/ and mask_visib/ PNGs from the analytic hits, {len(records)} "
        f"records at visib >= {cfg.datasets.filter_visib_thr}; {len(bg_paths)} 640x480 "
        f"backgrounds; bank decimated from 4096 to {bank.faces.shape[1]} faces "
        f"(max_faces={pc.gt_max_faces}), {pc.geo_head.num_regions} FPS keypoints; "
        f"{time.perf_counter() - t0:.1f} s")
    b2 = _train_b2(card, records, bank, meta)
    aug = _aug_check(card, cfg, records, meta, bg_paths)
    ctx = {"meta": meta, "records": records, "bank": bank, "bg_paths": bg_paths,
           "common": common, "tmp": tmp}
    run = _train_recipe(card, cfg, ctx, TRAIN_STEPS, TRAIN_LOSS_DROP, "[10/18]",
                        LN_PER_FORWARD)
    with no_tf32():
        _train_parity(card, records, bank, meta)
    return dict(run, lnb=lnb, b2=b2, aug=aug, ctx=ctx)


def phase_train_rgbd(card, ctx):
    """Phase 11: the BOP'22 RGB-D recipe (two convnext_base, concat fusion,
    depth augmentation) at full width through train_gdrn: launches per step
    (B1 80 + 80 + 80, B2 1 + 1), B1's backward at this path's shapes vs its
    plain version, the trainable loss, EMA != params, the checkpoint, the
    busy share, and one tiny dual-stream step card vs CPU."""
    from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd
    cfg = replace_cfg(ycbv_convnext_base_rgbd(), parse_opts(
        ctx["common"] + [f"output_dir={os.path.join(ctx['tmp'], 'train_rgbd_out')!r}"]))
    pc, inp = cfg.model.pose_net, cfg.input
    check(pc.name == "gdrn_dstream_double_mask" and pc.fuse_type == "cat"
          and pc.backbone.name == "convnext_base" and inp.with_depth and inp.depth_aug
          and inp.bp_depth and cfg.solver.ims_per_batch == TRAIN_BATCH
          and cfg.model.compute_dtype == "bfloat16",
          "ycbv_convnext_base_rgbd() is not the BOP'22 RGB-D recipe")
    # B1's backward at both backbones' shapes (the same four) in bf16
    g = torch.Generator(device="cuda").manual_seed(SEED + 41)
    worst = 0.0
    for r, C, _ in LN_SHAPES:
        err, rel, ok, _ = _ln_bwd_case(TRAIN_BATCH * r, C, torch.bfloat16, g)
        check(ok, f"B1 backward at ({TRAIN_BATCH * r}, {C}) bf16: dx err {err}, rel {rel}")
        worst = max(worst, err)
    log(f"[11/18] B1 backward vs plain at the dual stream's shapes (both backbones: "
        f"{', '.join(f'({TRAIN_BATCH * r}, {C})' for r, C, _ in LN_SHAPES)}, bf16): dx max "
        f"abs err {worst:.3e}, within one bf16 ulp + 1e-5; dweight / dbias within "
        f"{LN_BWD_REL_TOL} of the sum of their terms")
    run = _train_recipe(card, cfg, ctx, TRAIN_RGBD_STEPS, TRAIN_RGBD_LOSS_DROP, "[11/18]",
                        2 * LN_PER_FORWARD)
    with no_tf32():
        _train_parity(card, ctx["records"], ctx["bank"], ctx["meta"], over=DSTREAM, tag="[11/18]")
    return dict(run, ln_bwd_err=worst)


def phase_pool(card, ctx):
    """Pool mode on the flagship recipe: POOL_BATCHES training batches of
    frames kept on the card (uploads on a side stream) equal to the host
    batches of the same seed and draws, bit for bit; then POOL_STEPS steps
    through train_gdrn and the pools' stats."""
    from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base
    from gdrnpp_bop2022_torch.datasets.device_pool import FramePools
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.engine.trainer import (device_bank, make_generators,
                                                     prep_train_batch, train_gdrn)
    cfg = replace_cfg(ycbv_convnext_base(), parse_opts(
        ctx["common"] + [f"output_dir={os.path.join(ctx['tmp'], 'train_pool_out')!r}",
                         f"train.device_pool_frames={POOL_FRAMES}"]))
    meta, records, bank = ctx["meta"], ctx["records"], ctx["bank"]
    bnk = device_bank(bank, cfg.model.pose_net.geo_head.num_regions, "cuda")
    pools = FramePools(meta.height, meta.width, rgb_frames=POOL_FRAMES,
                       mask_frames=2 * POOL_FRAMES, bg_frames=cfg.train.device_pool_bg_frames,
                       device="cuda")
    kw = dict(seed=SEED + 17, bg_paths=ctx["bg_paths"], truncate_fg=cfg.input.truncate_fg)
    host = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, **kw)
    pooled = GdrnTrainLoader(records, TRAIN_BATCH, meta.width, meta.height, pools=pools, **kw)
    gh, gp = make_generators(SEED, "cuda"), make_generators(SEED, "cuda")
    try:
        for i in range(POOL_BATCHES):
            a = prep_train_batch(next(host), bnk, cfg, "cuda", gens=gh)
            b = prep_train_batch(next(pooled), bnk, cfg, "cuda", gens=gp)
            bad = [k for k in a if not torch.equal(a[k], b[k])]
            check(set(a) == set(b) and not bad, f"pool batch {i} differs from the host "
                  f"batch in {bad}")
    finally:
        host.close()
        pooled.close()
    log(f"[10/18] pool mode: {POOL_BATCHES} training batches from frames kept on the card "
        f"({pools.nbytes / 1e9:.2f} GB: {POOL_FRAMES} RGB, {2 * POOL_FRAMES} mask, "
        f"{cfg.train.device_pool_bg_frames} background slots; uploads on a side stream) equal "
        f"the host batches of the same seed and draws bit for bit (augmented crops, masks, "
        f"XYZ, regions); pools {pools.stats()}")
    stats = {}
    state = train_gdrn(cfg, records, bank, max_iters=POOL_STEPS, resume=False, meta=meta,
                       stats=stats)
    torch.cuda.synchronize()
    check(state.step == POOL_STEPS, "pool-mode training did not run")
    steps_ms = stats["step"][1:]
    log(f"[10/18] pool-mode training (train.device_pool_frames={POOL_FRAMES}) for "
        f"{POOL_STEPS} steps: step mean {float(np.mean(steps_ms)):.2f} ms (steps 2.."
        f"{POOL_STEPS - 1}), H2D + pool gathers {float(np.mean(stats['h2d'][1:])):.2f} ms, host "
        f"wait {float(np.mean(stats['host_wait'][1:])):.2f} ms; pools {stats['pool']}  "
        f"[{card}]")
    del state
    torch.cuda.empty_cache()
    return {"stats": stats["pool"], "step_ms": float(np.mean(steps_ms))}


# ---------------------------------------------------------------------------
# the detector (phase 12) and the two-stage path (phase 13)
# ---------------------------------------------------------------------------

def _numpy_greedy(boxes, score, cls, nms_thr, max_dets):
    """An independent greedy NMS in numpy over one image's decoded boxes
    (A, 4 xyxy), scores (A,) and classes (A,): the top k = min(4 max_dets, A)
    by score, then kept in score order unless a kept box of the same class
    overlaps it above nms_thr. Returns the kept indices, at most max_dets."""
    order = np.argsort(-score, kind="stable")[:min(4 * max_dets, len(score))]
    kept = []
    for j in order:
        if score[j] <= 0:
            break
        if kept:
            kb = boxes[kept]
            tl = np.maximum(kb[:, :2], boxes[j, :2])
            br = np.minimum(kb[:, 2:], boxes[j, 2:])
            inter = np.prod(np.maximum(br - tl, np.float32(0)), -1)
            area = lambda b: np.prod(np.maximum(b[..., 2:] - b[..., :2], np.float32(0)), -1)  # noqa: E731
            iou = inter / np.maximum(area(kb) + area(boxes[j]) - inter, np.float32(1e-9))
            if ((iou > nms_thr) & (cls[kept] == cls[j])).any():
                continue
        kept.append(j)
    return kept[:max_dets]


def _check_nms_numpy(flat, grids, st, conf_thr, nms_thr, tag):
    """The card's postprocess_nms against _numpy_greedy on the same raw rows:
    the decode and scores within fp32 rounding of numpy's own, then, on the
    card's decoded values, the same kept rows bit for bit."""
    from gdrnpp_bop2022_torch.models.yolox.head import cxcywh_to_xyxy, decode_outputs
    from gdrnpp_bop2022_torch.models.yolox.yolox import postprocess_nms
    with torch.inference_mode():
        out = {k: v.cpu().numpy() for k, v in
               postprocess_nms(flat, grids, st, conf_thr=conf_thr, nms_thr=nms_thr).items()}
        boxes, obj, cls_l = decode_outputs(flat, grids, st)
        sc_all = torch.sigmoid(obj)[..., None] * torch.sigmoid(cls_l)
        conf, cid = sc_all.amax(-1), sc_all.argmax(-1)
        score = torch.where(conf > conf_thr, conf, torch.zeros_like(conf))
        xyxy = cxcywh_to_xyxy(boxes)
    f, g, s = (t.cpu().numpy() for t in (flat, grids, st))
    sig = lambda z: 1.0 / (1.0 + np.exp(-z.astype(np.float64)))      # noqa: E731
    np_conf = (sig(f[..., 4])[..., None] * sig(f[..., 5:])).max(-1)
    np_xy = (f[..., 0:2] + g[None]) * s[None, :, None]
    dec_err = float(np.abs(np_conf - conf.cpu().numpy()).max())
    xy_err = float(np.abs(np_xy - boxes[..., :2].cpu().numpy()).max())
    check(dec_err < 1e-5 and xy_err < 1e-3, f"{tag}: decode vs numpy {dec_err}, {xy_err}")
    xyxy, score, cid = xyxy.cpu().numpy(), score.cpu().numpy(), cid.cpu().numpy()

    def table(boxes, scores, labels):
        """Rows sorted by score, then box and label: torch.topk and numpy
        order candidates of exactly equal score differently."""
        t = np.concatenate([-scores[:, None], boxes, labels[:, None].astype(np.float32)], 1)
        return t[np.lexsort(t.T[::-1])]

    n_kept = []
    for b in range(flat.shape[0]):
        kept = _numpy_greedy(xyxy[b], score[b], cid[b], nms_thr, 100)
        v = out["valid"][b]
        n = int(v.sum())
        check(n == len(kept) and v[:n].all() and np.array_equal(
            table(out["boxes_xyxy"][b][:n], out["scores"][b][:n], out["labels"][b][:n]),
            table(xyxy[b][kept], score[b][kept], cid[b][kept])),
            f"{tag}: image {b}: the card's NMS != the numpy greedy NMS")
        n_kept.append(n)
    return n_kept, dec_err


def _launches(fn):
    """Kernels and copies one call of fn() puts on the card (profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def phase_detector(card, scene):
    """yolox-x at 640x640 (21 classes, bf16), GN and BN (BN with drawn
    running statistics), weights from the seed, at batch 8 on the RGB-D
    scene's 24 images: plain and TTA detection times, the NMS's share,
    launches, peak memory; the NMS against numpy; the card against the CPU
    in fp32; GT boxes scored as detections."""
    from gdrnpp_bop2022_torch.configs import yolox as yolox_recipe
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split, load_image
    from gdrnpp_bop2022_torch.datasets.yolox_loader import letterbox
    from gdrnpp_bop2022_torch.eval.detection_eval import coco_map
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    from gdrnpp_bop2022_torch.models.yolox.head import flatten_outputs
    from gdrnpp_bop2022_torch.models.yolox.yolox import (make_inference, make_tta_inference,
                                                         postprocess_nms, tta_rows)
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    rc = yolox_recipe("ycbv")
    check(rc.size == "yolox_x" and rc.input_size == 640 and rc.test.tta
          and rc.test.tta_scales == (1.0, 0.75, 0.83, 1.12, 1.25) and rc.test.conf_thr_tta == 0.001
          and rc.test.nms_thr == 0.65, "configs.yolox('ycbv') is not the BOP'22 recipe")
    meta = scene["meta"]
    by_im = {}
    for r in index_bop_split(scene["split_dir"], meta):
        by_im.setdefault(r.scene_im_id, []).append(r)
    keys = sorted(by_im, key=lambda k: int(k.split("/")[1]))
    canv = [letterbox(load_image(by_im[k][0].rgb_path), rc.input_size) for k in keys]
    batches = [torch.from_numpy(np.stack([c for c, _ in canv[i:i + DET_BATCH]])).cuda().float()
               for i in range(0, len(keys), DET_BATCH)]
    x = batches[0]
    gts = {k: [{"bbox_xyxy": r.bbox_visib, "label": r.label} for r in by_im[k]] for k in keys}
    m_gt = coco_map({k: [dict(g, score=1.0) for g in v] for k, v in gts.items()}, gts,
                    meta.num_classes)
    check(abs(m_gt["mAP"] - 100 / 101) < 1e-9 and abs(m_gt["AP50"] - 100 / 101) < 1e-9,
          f"GT boxes as detections: {m_gt}")
    log(f"[12/18] {len(keys)} images letterboxed to {rc.input_size}^2 in batches of "
        f"{DET_BATCH}; GT boxes as detections: mAP = AP50 = {m_gt['mAP']:.6f} (100/101, the "
        f"top of coco_map's 101-point interpolation)")
    res, models = {}, {}
    for norm in ("GN", "BN"):
        model = build_yolox(meta.num_classes, rc.size, norm=norm)
        check(next(model.parameters()).is_cuda, "build_yolox did not build on the card")
        model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
        n_par = sum(p.numel() for p in model.parameters())
        plain = make_inference(model, conf_thr=DET_CONF_PLAIN, nms_thr=rc.test.nms_thr)
        tta = make_tta_inference(model, scales=rc.test.tta_scales, flip=True,
                                 conf_thr=rc.test.conf_thr_tta, nms_thr=rc.test.nms_thr)
        with torch.inference_mode():
            flat, grids, st = flatten_outputs(model(x), model.strides)
            rows = tta_rows(model, x, rc.test.tta_scales, True)
        A = rows.shape[1]
        zeros, ones = (torch.zeros(A, 2, device="cuda"), torch.ones(A, device="cuda"))
        n_plain, err_plain = _check_nms_numpy(flat, grids, st, DET_CONF_PLAIN, rc.test.nms_thr,
                                              f"{norm} plain NMS")
        n_tta, err_tta = _check_nms_numpy(rows, zeros, ones, rc.test.conf_thr_tta,
                                          rc.test.nms_thr, f"{norm} TTA NMS")
        with torch.inference_mode():
            t = {"forward_ms": cuda_ms(lambda: model(x), iters=DET_REPS),
                 "plain_ms": cuda_ms(lambda: plain(x), iters=DET_REPS),
                 "nms_plain_ms": cuda_ms(lambda: postprocess_nms(
                     flat, grids, st, DET_CONF_PLAIN, rc.test.nms_thr), iters=DET_REPS)}
            torch.cuda.reset_peak_memory_stats()
            t["tta_ms"] = cuda_ms(lambda: tta(x), iters=3, warmup=1)
            t["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            t["nms_tta_ms"] = cuda_ms(lambda: postprocess_nms(
                rows, zeros, ones, rc.test.conf_thr_tta, rc.test.nms_thr), iters=DET_REPS)
            outs = [{k: v.cpu().numpy() for k, v in tta(b).items()} for b in batches]
        t.update(plain_img_s=DET_BATCH / t["plain_ms"] * 1e3,
                 tta_img_s=DET_BATCH / t["tta_ms"] * 1e3,
                 nms_share_plain=t["nms_plain_ms"] / t["plain_ms"],
                 nms_share_tta=t["nms_tta_ms"] / t["tta_ms"], anchors_tta=A, params=n_par,
                 kept_plain=n_plain, kept_tta=n_tta, decode_err=max(err_plain, err_tta))
        dets = {}
        for bi, o in enumerate(outs):
            for j, k in enumerate(keys[bi * DET_BATCH:(bi + 1) * DET_BATCH]):
                keep = o["valid"][j] & (o["scores"][j] > 0)
                check(np.isfinite(o["boxes_xyxy"][j][keep]).all(), f"{norm}: non-finite boxes")
                dets[k] = [{"bbox_xyxy": b / canv[bi * DET_BATCH + j][1], "label": int(lab),
                            "score": float(s)} for b, lab, s in
                           zip(o["boxes_xyxy"][j][keep], o["labels"][j][keep],
                               o["scores"][j][keep])]
        t["map_random"] = coco_map(dets, gts, meta.num_classes)["mAP"]
        res[norm] = t
        models[norm] = (plain, tta)
    # launches last, after the times: one profiled call of each path
    for norm, (plain, tta) in models.items():
        t = res[norm]
        with torch.inference_mode():
            t["launches_plain"] = _launches(lambda: plain(x))
            t["launches_tta"] = _launches(lambda: tta(x))
        log(f"[12/18] yolox-x {norm} ({t['params'] / 1e6:.2f} M params, bf16, batch {DET_BATCH} at "
            f"640^2): forward {t['forward_ms']:.2f} ms; plain detection (forward + decode + "
            f"NMS, conf {DET_CONF_PLAIN}) {t['plain_ms']:.2f} ms = {t['plain_img_s']:.1f} "
            f"images/s, NMS {t['nms_plain_ms']:.3f} ms ({100 * t['nms_share_plain']:.1f}%), "
            f"{t['launches_plain']} kernels and copies a batch; TTA (5 scales x flip, "
            f"{t['anchors_tta']} anchors an image, conf {rc.test.conf_thr_tta}) "
            f"{t['tta_ms']:.2f} ms = "
            f"{t['tta_img_s']:.1f} images/s, NMS {t['nms_tta_ms']:.3f} ms "
            f"({100 * t['nms_share_tta']:.2f}%), {t['launches_tta']} kernels and copies a "
            f"batch, peak {t['peak_gb']:.2f} GB (CUDA events)  [{card}]")
        log(f"[12/18] {norm}: the card's NMS == a numpy greedy NMS on the same raw rows, every "
            f"image (kept {t['kept_plain']} plain, {t['kept_tta']} under TTA; scores vs "
            f"numpy's decode {t['decode_err']:.1e}); random weights score mAP "
            f"{t['map_random']:.4f} on the scene's GT boxes")
    del models, plain, tta, model, flat, rows
    torch.cuda.empty_cache()

    # card vs CPU in fp32 on 2 of the images, TF32 off
    errs = {}
    with no_tf32(), torch.inference_mode():
        for norm in ("GN", "BN"):
            outs = {}
            for dev in ("cuda", "cpu"):
                m = build_yolox(meta.num_classes, rc.size, norm=norm, device=dev,
                                dtype=torch.float32)
                m.load_state_dict(seeded_state_dict(m, SEED), strict=True)
                outs[dev] = [o.cpu() for o in m(x[:2].to(dev))]
                del m
            errs[norm] = max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(outs["cuda"], outs["cpu"]))
            check(errs[norm] <= DET_PARITY_TOL and all(torch.isfinite(o).all()
                                                       for o in outs["cuda"]),
                  f"yolox-x {norm} fp32 card vs CPU: {errs[norm]} > {DET_PARITY_TOL}")
    log(f"[12/18] yolox-x fp32 card vs CPU on 2 images, TF32 off: raw outputs within "
        f"GN {errs['GN']:.2e} / BN {errs['BN']:.2e} of each level's largest magnitude "
        f"(limit {DET_PARITY_TOL})")
    torch.cuda.empty_cache()
    return dict(res, parity=errs)


def phase_two_stage(card, scene, tmp):
    """python -m ...tools.test_yolox (the ycbv recipe: TTA) on the scene ->
    the handoff json -> test_gdrn with model.load_dets_test=True (B1's
    launches counted) -> CSV -> python -m ...tools.score_csv; then
    python -m ...tools.demo_gdrn with the detector inline on DEMO_IMAGES
    images."""
    import contextlib
    import io
    import re
    from torch.nn.modules.module import register_module_forward_hook
    from gdrnpp_bop2022_torch.bop.inout import load_json
    from gdrnpp_bop2022_torch.models.gdrn import GDRN
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.tools import test_gdrn

    root = os.path.dirname(os.path.dirname(scene["models_dir"]))    # holds ycbv/
    here = os.path.dirname(os.path.abspath(__file__))
    out = os.path.join(tmp, "two_stage")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gdrnpp_bop2022_torch.tools.test_yolox",
                           "--config", "ycbv", "--root", root, "--allow-random-weights",
                           "--out", out], capture_output=True, text=True,
                          timeout=600, cwd=here)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"test_yolox CLI failed: {proc.stderr[-2000:]}")
    det_file = os.path.join(out, "yolox_ycbv_test_bboxes.json")
    handoff = load_json(det_file)
    n_rows = sum(len(v) for v in handoff.values())
    check(len(handoff) == N_IMAGES and all(0 < len(v) <= 100 for v in handoff.values())
          and all(np.isfinite(r["bbox_est"]).all() and 0 < r["score"] <= 1
                  for v in handoff.values() for r in v), "test_yolox's handoff json")
    rate = re.search(r"([0-9.]+) images/s in detection", proc.stdout)
    log(f"[13/18] python -m gdrnpp_bop2022_torch.tools.test_yolox --config ycbv (yolox-x GN "
        f"bf16, TTA 5 scales x flip, batch 8, random weights): {N_IMAGES} images, {n_rows} "
        f"rows in the handoff json; {rate.group(1) if rate else '?'} images/s in detection "
        f"(host clock after the copy back), {cli_s:.1f} s for the whole CLI with the process "
        f"start  [{card}]")

    forwards = [0]
    hook = register_module_forward_hook(
        lambda m, i, o: forwards.__setitem__(0, forwards[0] + isinstance(m, GDRN)))
    opts = [f"datasets.root={root!r}", "datasets.test=('ycbv_test',)",
            "model.load_dets_test=True", f"datasets.det_files_test=({det_file!r},)",
            f"output_dir={os.path.join(tmp, 'gdrn_two_stage')!r}", "val.save_results_only=True"]
    layer_norm.launches = 0                       # count this path only
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            results, _ = test_gdrn.main(["--config", "default", "--seed", str(SEED),
                                         "--opts", *opts])
    finally:
        hook.remove()
    gdrn_s = time.perf_counter() - t0
    launches = layer_norm.launches
    check(forwards[0] > 1 and launches == LN_PER_FORWARD * forwards[0],
          f"two-stage: layer_norm launches {launches} != 40 x {forwards[0]} forwards")
    served = re.search(r"served (\d+) ROIs in (\d+) batches .*: ([0-9.]+) ROI/s, p50 ([0-9.]+)",
                       buf.getvalue())
    check(served is not None and int(served.group(1)) == len(results) > 0,
          f"test_gdrn's output: {buf.getvalue()[-500:]}")
    csv = os.path.join(tmp, "gdrn_two_stage", "inference", "ycbv_test", "poses.csv")
    _check_rows(results, len(results), tmp, "two_stage")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gdrnpp_bop2022_torch.tools.score_csv",
                           "--csv", csv, "--dataset", "ycbv", "--root", root],
                          capture_output=True, text=True, timeout=600, cwd=here)
    check(proc.returncode == 0, f"score_csv on the two-stage CSV failed: {proc.stderr[-2000:]}")
    scores = json.loads(proc.stdout)
    ar_keys = ("AR", "AR_vsd", "AR_mssd", "AR_mspd")
    check(all(np.isfinite(scores[k]) and 0.0 <= scores[k] <= 1.0 for k in ar_keys),
          f"two-stage scores {scores}")
    log(f"[13/18] test_gdrn (flagship Config(), bf16) on the handoff json with "
        f"model.load_dets_test=True (top 1 per object): {served.group(1)} ROIs in "
        f"{served.group(2)} batches, {served.group(3)} ROI/s, p50 {served.group(4)} ms a batch "
        f"(host clock after synchronize), {gdrn_s:.1f} s in all; {forwards[0]} forwards, "
        f"layer_norm launches {launches} = 40 x {forwards[0]}; score_csv on its CSV: "
        + " ".join(f"{k}={scores[k]:.4f}" for k in ar_keys)
        + f" ({time.perf_counter() - t0:.1f} s)  [{card}]")

    imgs = sorted(os.path.join(scene["split_dir"], "000048", "rgb", f)
                  for f in os.listdir(os.path.join(scene["split_dir"], "000048", "rgb")))
    demo_out = os.path.join(tmp, "demo")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gdrnpp_bop2022_torch.tools.demo_gdrn",
                           "--config", "default", "--seed", str(SEED), "--images",
                           *imgs[:DEMO_IMAGES], "--yolox-random-weights", "--out", demo_out,
                           "--opts", f"datasets.root={root!r}"],
                          capture_output=True, text=True, timeout=600, cwd=here)
    demo_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"demo_gdrn failed: {proc.stderr[-2000:]}")
    drawn = sorted(os.listdir(demo_out))
    check(drawn == sorted(os.path.basename(p) for p in imgs[:DEMO_IMAGES]),
          f"demo_gdrn drew {drawn}")
    n_obj = sum(int(n) for n in re.findall(r"\((\d+) objects\)", proc.stdout))
    log(f"[13/18] python -m gdrnpp_bop2022_torch.tools.demo_gdrn with yolox-x inline (GN, bf16, "
        f"conf 0.3) and the flagship GDRN on {DEMO_IMAGES} images: {n_obj} posed objects drawn, "
        f"{demo_s:.1f} s with the process start  [{card}]")
    return {"launches": launches, "forwards": forwards[0], "rois": len(results),
            "roi_per_s": float(served.group(3)), "test_yolox_cli_s": cli_s,
            "scores": {k: scores[k] for k in ar_keys}}


# ---------------------------------------------------------------------------
# detector training (phase 14)
# ---------------------------------------------------------------------------

def _yx_batch(B, S, nc, rs, G=60, device="cuda"):
    """A random detection batch on ``device``: noise images (B, S, S, 3) and
    1..G valid GT boxes an image, padded to G (the loader's max_gt)."""
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., :2] = rs.uniform(0.1 * S, 0.9 * S, (B, G, 2))
    boxes[..., 2:] = rs.uniform(0.02 * S, 0.4 * S, (B, G, 2))
    n = rs.randint(1, G + 1, B)
    batch = {"images": rs.uniform(0, 255, (B, S, S, 3)).astype(np.float32),
             "gt_boxes": boxes, "gt_labels": rs.randint(0, nc, (B, G)).astype(np.int32),
             "gt_valid": np.arange(G)[None] < n[:, None]}
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _yx_state(nc, size, norm, seed, lr, device="cuda", dtype=torch.bfloat16):
    """A train state as train_yolox builds it: flax-default weights from the
    seed, clip 35 + Ranger at ``lr`` (a constant), EMA 0.9998."""
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.yolox_trainer import (build_yolox_optimizer,
                                                           init_yolox_weights)
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    model = build_yolox(nc, size, norm=norm, device=device, dtype=dtype)
    init_yolox_weights(model, seed)
    model.train()
    return create_train_state(model, build_yolox_optimizer(model, lr, "ranger", 0.0),
                              ema_decay=0.9998)


def _yx_pick_batch(card, nc):
    """The first batch of YX_BATCHES whose one training step of yolox-x (GN,
    bf16) at YX_PROBE_SIZE^2 peaks under YX_MEM_GB; each tried batch's peak."""
    import gc
    from gdrnpp_bop2022_torch.engine.yolox_trainer import make_yolox_train_step
    step = make_yolox_train_step()
    tried = {}
    for B in YX_BATCHES:
        state = None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            state = _yx_state(nc, "yolox_x", "GN", SEED, 1e-4)
            step(state, _yx_batch(B, YX_PROBE_SIZE, nc, np.random.RandomState(SEED)))
            torch.cuda.synchronize()
            tried[B] = torch.cuda.max_memory_allocated() / 1e9
        except torch.cuda.OutOfMemoryError:
            tried[B] = None
        del state
        gc.collect()
        torch.cuda.empty_cache()
        if tried[B] is not None and tried[B] < YX_MEM_GB:
            break
    log(f"[14/18] yolox-x GN bf16, one training step at {YX_PROBE_SIZE}^2: peak "
        "max_memory_allocated " + ", ".join(
            f"batch {b}: " + (f"{gb:.2f} GB" if gb is not None else "out of memory")
            for b, gb in tried.items()) + f" (limit {YX_MEM_GB} GB)  [{card}]")
    B = next((b for b, gb in tried.items() if gb is not None and gb < YX_MEM_GB), None)
    check(B is not None, f"no batch of {YX_BATCHES} fits: {tried}")
    return B, tried


def _yx_loss(model, batch, weights=None):
    """yolox_loss's terms of ``model`` (or of it with ``weights``) on a
    batch, no gradient: {name: float}."""
    from gdrnpp_bop2022_torch.models.yolox.head import yolox_loss
    with torch.no_grad():
        imgs = batch["images"].float()
        outs = (model(imgs) if weights is None
                else torch.func.functional_call(model, weights, (imgs,)))
        losses = yolox_loss(outs, model.strides, batch["gt_boxes"], batch["gt_labels"],
                            batch["gt_valid"])
        return {k: float(losses[k]) for k in ("loss_iou", "loss_obj", "loss_cls", "total_loss")}


def _yx_profile(card, state, batch, B):
    """torch.profiler over TRAIN_PROFILE_STEPS steps on a batch already on
    the card (the loader's wait excluded): wall, device busy share, kernels
    and copies a step."""
    from gdrnpp_bop2022_torch.engine.yolox_trainer import make_yolox_train_step
    step = make_yolox_train_step()
    wall_ms, busy, n_k, ev = profile_calls(lambda: step(state, batch), TRAIN_PROFILE_STEPS)
    log(f"[14/18] profiled yolox-x training step at batch {B}, 640^2 ({TRAIN_PROFILE_STEPS} "
        f"steps, the batch on the card): {wall_ms:.2f} ms wall, {busy:.2f} ms of device time "
        f"({100 * busy / wall_ms:.1f}% busy), {n_k} kernels and copies; top (ms per step, "
        f"count): " + "; ".join(f"{k[:60]} {ms:.2f} ({c})" for k, ms, c in ev[:TRAIN_PROFILE_TOP])
        + f"  [{card}]")
    return {"wall_ms": wall_ms, "busy_ms": busy, "kernels": n_k}


def _yx_recipe(card, scene, tmp):
    """configs.yolox("ycbv") through train_yolox at the batch that fits;
    returns its numbers and the run's output directory."""
    import dataclasses
    from gdrnpp_bop2022_torch.configs import yolox as yolox_recipe
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
    from gdrnpp_bop2022_torch.datasets.yolox_loader import (YoloxTrainLoader,
                                                            det_records_from_instances)
    from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.yolox_trainer import (build_yolox_optimizer,
                                                           train_yolox)
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    from gdrnpp_bop2022_torch.models.yolox.head import (decode_outputs, flatten_outputs,
                                                        simota_match)
    rc = yolox_recipe("ycbv")
    check(rc.size == "yolox_x" and rc.norm == "GN" and rc.optimizer == "ranger"
          and rc.basic_lr_per_img == 1e-3 / 64 and rc.weight_decay == 0.0
          and rc.grad_clip == 35.0 and rc.ema_decay == 0.9998 and rc.random_size == (14, 26)
          and rc.multiscale_period == 10 and rc.aug.mosaic_prob == 1.0
          and rc.aug.mixup_prob == 1.0 and rc.batch_size == 32,
          "configs.yolox('ycbv') is not the BOP'22 training recipe")
    meta = scene["meta"]
    records = det_records_from_instances(index_bop_split(scene["split_dir"], meta))
    records, held_records = records[:-YX_HELD], records[-YX_HELD:]
    B, tried = _yx_pick_batch(card, meta.num_classes)

    # a batch of the images held apart (no augmentation) and the initial
    # weights' losses on it (train_yolox draws the same weights from the seed)
    loader = YoloxTrainLoader(held_records, B, rc.input_size, seed=SEED + 5, enable_aug=False)
    try:
        held = {k: torch.as_tensor(v).cuda() for k, v in next(loader).items()}
    finally:
        loader.close()
    st0 = _yx_state(meta.num_classes, rc.size, rc.norm, SEED, 1e-4)
    loss0 = _yx_loss(st0.model.eval(), held)
    del st0
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "yolox_train")
    stats = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_yolox(records, meta.num_classes, out, size=rc.size, input_size=rc.input_size,
                        batch_size=B, total_iters=YX_STEPS, base_lr=rc.basic_lr_per_img,
                        weight_decay=rc.weight_decay, optimizer=rc.optimizer,
                        warmup_iters=YX_WARMUP, grad_clip=rc.grad_clip,
                        aug=dataclasses.asdict(rc.aug), no_aug_iters=YX_NOAUG,
                        log_period=YX_LOG_PERIOD, ckpt_period=YX_STEPS, seed=SEED,
                        random_size=rc.random_size, multiscale_period=rc.multiscale_period,
                        ema_decay=rc.ema_decay, norm=rc.norm, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(state.step == YX_STEPS and next(state.model.parameters()).is_cuda,
          "train_yolox did not run on the card")
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics_yolox.json"))]
    check(all(np.isfinite(r["total_loss"]) for r in rows), f"non-finite losses: {rows}")
    check("loss_l1" in rows[-1] and "loss_l1" not in rows[0], "the no-aug switch (L1) did not run")
    sizes = [r["img_size"] for r in rows]
    loss_ema = _yx_loss(state.model.eval(), held, state.ema_state_dict())
    state.model.train()
    ratio = {k: loss_ema[k] / loss0[k] for k in loss0}
    log(f"[14/18] on a batch of {B} drawn from the {YX_HELD} images held apart, initial -> EMA "
        "weights: " + "; ".join(f"{k} {loss0[k]:.4f} -> {loss_ema[k]:.4f} ({ratio[k]:.3f}x)"
                                for k in loss0) + f" (each term must fall below {YX_LOSS_DROP}x)")
    check(all(np.isfinite(v) and ratio[k] < YX_LOSS_DROP for k, v in loss_ema.items()
              if k != "total_loss"),
          f"a held-apart loss did not fall: {loss0} at the initial weights, {loss_ema} at "
          f"the EMA weights after {YX_STEPS} iterations")
    check(any(not torch.equal(e, p) for e, p in zip(state.ema, state.model.parameters())),
          "the EMA weights equal the parameters")

    steps_ms = stats["step"][TRAIN_SKIP:]
    pct = lambda a, q: float(np.percentile(a, q))            # noqa: E731
    mean = lambda k: float(np.mean(stats[k][TRAIN_SKIP:]))   # noqa: E731
    img_s = B * len(steps_ms) / (sum(steps_ms) / 1e3)
    split = {k: mean(k) for k in ("h2d", "resize", "fwd_bwd", "opt_ema")}
    wait = stats["host_wait"][TRAIN_SKIP:]
    # simOTA alone on the held batch's outputs at 640^2
    with torch.no_grad():
        flat, grids, st = flatten_outputs(state.model(held["images"].float()), state.model.strides)
        bd, ol, cl = decode_outputs(flat, grids, st)
        simota_ms = cuda_ms(lambda: simota_match(bd, ol, cl, grids, st, held["gt_boxes"],
                                                 held["gt_labels"], held["gt_valid"]),
                            iters=5, warmup=1)
    del flat, bd, ol, cl
    log(f"[14/18] trained configs.yolox('ycbv') (yolox-x {sum(p.numel() for p in state.model.parameters()) / 1e6:.2f} M "
        f"params, GN, bf16, Ranger {rc.basic_lr_per_img * B:.2e} at batch {B}, warmup "
        f"{YX_WARMUP}, clip 35, EMA 0.9998, mosaic + mixup + HSV + flip, multiscale "
        f"{rc.random_size} x 32 every {rc.multiscale_period}, no-aug + L1 for the last "
        f"{YX_NOAUG}) for {YX_STEPS} iterations through train_yolox in {wall:.1f} s on "
        f"{len(records)} images: sizes logged {sizes}; total_loss logged every "
        f"{YX_LOG_PERIOD}: " + " ".join(f"{r['total_loss']:.3f}" for r in rows)
        + f"  [{card}]")
    log(f"[14/18] yolox-x training step at batch {B} (CUDA events, steps {TRAIN_SKIP + 1}.."
        f"{YX_STEPS - 1}): p50 {pct(steps_ms, 50):.2f} ms, p99 {pct(steps_ms, 99):.2f} ms = "
        f"{img_s:.1f} images/s; per step mean: H2D {split['h2d']:.2f} ms, multiscale resize "
        f"{split['resize']:.2f} ms, forward + loss + backward {split['fwd_bwd']:.2f} ms (simOTA "
        f"alone at 640^2: {simota_ms:.2f} ms), optimizer + EMA {split['opt_ema']:.2f} ms; host "
        f"wait on the loader mean {float(np.mean(wait)):.2f} ms, p99 {pct(wait, 99):.2f} ms; "
        f"peak max_memory_allocated {peak_gb:.2f} GB  [{card}]")

    # the checkpoint, restored into a fresh state on the card
    mgr = CheckpointManager(os.path.join(out, "ckpt_yolox"))
    check(mgr.latest_step() == YX_STEPS, f"checkpoint steps: {mgr.latest_step()}")
    model = build_yolox(meta.num_classes, rc.size, norm=rc.norm)
    fresh = create_train_state(model, build_yolox_optimizer(model, 1e-3, "ranger", 0.0))
    mgr.restore_latest(fresh)
    same = (fresh.step == YX_STEPS
            and all(torch.equal(a, b) for a, b in zip(state.model.state_dict().values(),
                                                      fresh.model.state_dict().values()))
            and all(torch.equal(a, b) for a, b in zip(state.ema, fresh.ema))
            and all(torch.equal(v, fresh.optimizer.state[q][k])
                    for p, q in zip(state.model.parameters(), fresh.model.parameters())
                    for k, v in state.optimizer.state[p].items()))
    check(same, "the yolox checkpoint did not restore params, EMA and optimizer state bit "
          "for bit")
    log(f"[14/18] checkpoint of iteration {YX_STEPS} "
        f"({os.path.getsize(mgr.path(YX_STEPS)) / 1e9:.2f} GB) restored on the card: params, "
        f"EMA and Ranger state bit for bit")
    del fresh, model
    prof = _yx_profile(card, state, held, B)
    del state, held
    torch.cuda.empty_cache()
    return {"batch": B, "peak_probe_gb": tried, "step_p50_ms": pct(steps_ms, 50),
            "step_p99_ms": pct(steps_ms, 99), "images_s": img_s, "split_ms": split,
            "simota_ms": simota_ms, "host_wait_ms": float(np.mean(wait)), "peak_gb": peak_gb,
            "loss_ratio": ratio, "profile": prof, "wall_s": wall}, out


def _yx_bn(card, scene, tmp):
    """The BN variant: YX_BN_STEPS iterations through train_yolox(norm="BN"),
    then one step whose running-statistics update is recomputed in float64
    from each BN's input."""
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
    from gdrnpp_bop2022_torch.datasets.yolox_loader import (YoloxTrainLoader,
                                                            det_records_from_instances)
    from gdrnpp_bop2022_torch.engine.yolox_trainer import make_yolox_train_step, train_yolox
    from gdrnpp_bop2022_torch.models.yolox.darknet import BatchNormFp32
    meta = scene["meta"]
    records = det_records_from_instances(index_bop_split(scene["split_dir"], meta))
    state = train_yolox(records, meta.num_classes, os.path.join(tmp, "yolox_bn"),
                        size="yolox_x", input_size=640, batch_size=YX_BN_BATCH,
                        total_iters=YX_BN_STEPS, base_lr=1e-3 / 64, optimizer="ranger",
                        weight_decay=0.0, warmup_iters=1, log_period=1, ckpt_period=100,
                        norm="BN", seed=SEED)
    bns = [m for m in state.model.modules() if isinstance(m, BatchNormFp32)]
    moved = sum(not (torch.all(m.running_mean == 0) and torch.all(m.running_var == 1))
                for m in bns)
    check(moved == len(bns), f"BN running statistics moved in {moved} of {len(bns)} layers")
    captured = []

    def hook(mod, inp):
        x = inp[0].detach().double()
        captured.append((mod, x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False),
                         mod.running_mean.double().clone(), mod.running_var.double().clone()))

    handles = [m.register_forward_pre_hook(hook) for m in bns]
    loader = YoloxTrainLoader(records, YX_BN_BATCH, 640, seed=SEED + 6)
    try:
        batch = {k: torch.as_tensor(v).cuda() for k, v in next(loader).items()}
    finally:
        loader.close()
    try:
        make_yolox_train_step()(state, batch)
    finally:
        for h in handles:
            h.remove()
    err = 0.0
    for mod, mu, var, rm, rv in captured:
        for got, want in ((mod.running_mean, 0.97 * rm + 0.03 * mu),
                          (mod.running_var, 0.97 * rv + 0.03 * var)):
            err = max(err, float((got.double() - want).abs().max() / want.abs().max()))
    check(len(captured) == len(bns) and err <= YX_BN_TOL,
          f"BN running statistics vs a float64 recomputation: {err} > {YX_BN_TOL}")
    log(f"[14/18] BN variant (yolox-x, norm BN, bf16, batch {YX_BN_BATCH} at 640^2): "
        f"{YX_BN_STEPS} iterations through train_yolox moved the running statistics of all "
        f"{len(bns)} BatchNorms; one more step's update equals 0.97 old + 0.03 x the batch's "
        f"biased mean and variance recomputed in float64 from each BN's input within "
        f"{err:.2e} of each tensor's largest (limit {YX_BN_TOL})")
    del state, batch, captured
    torch.cuda.empty_cache()
    return err


def _yx_parity(card, nc=3):
    """One fp32 step of a BN YOLOX (dep 0.33, wid 0.125) on the card and on
    the CPU, the same weights and batch, TF32 off; simOTA on the card vs the
    CPU on a tie-free batch at 640^2."""
    from gdrnpp_bop2022_torch.engine.yolox_trainer import make_yolox_train_step
    from gdrnpp_bop2022_torch.models.yolox.head import (decode_outputs, flatten_outputs,
                                                        simota_assign)
    from gdrnpp_bop2022_torch.models.yolox.yolox import YOLOX
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.yolox_trainer import (build_yolox_optimizer,
                                                           init_yolox_weights)
    batch = _yx_batch(2, 128, nc, np.random.RandomState(SEED + 7), G=8, device="cpu")
    res = {}
    with no_tf32():
        for dev in ("cuda", "cpu"):
            m = YOLOX(nc, 0.33, 0.125, norm="BN", dtype=torch.float32).to(dev)
            init_yolox_weights(m, SEED)
            st = create_train_state(m, build_yolox_optimizer(m, YX_PAR_LR, "ranger", 0.0))
            metrics = make_yolox_train_step()(st, {k: v.to(dev) for k, v in batch.items()})
            res[dev] = (float(metrics["total_loss"]),
                        {k: p.grad.cpu() for k, p in m.named_parameters()},
                        {k: v.cpu() for k, v in m.state_dict().items()})
    (lc, gc_, pc), (lh, gh, ph) = res["cuda"], res["cpu"]
    rel = lambda a, b: float((a.double() - b.double()).abs().max()    # noqa: E731
                             / b.double().abs().max().clamp_min(1e-30))
    loss_err = abs(lc - lh) / abs(lh)
    grad_err = max(rel(gc_[k], gh[k]) for k in gh)
    # each parameter's difference over its allowance (<= 1 passes)
    param_err = max(float((pc[k].double() - ph[k].double()).abs().max()
                          / (YX_PAR_TOL * ph[k].double().abs().max()
                             + 2 * YX_PAR_LR * (gc_[k].double() - gh[k].double()).abs().max()))
                    for k in gh)
    stats_err = max(rel(pc[k], ph[k]) for k in ph if k.endswith(("running_mean", "running_var")))
    check(np.isfinite(lc) and loss_err <= YX_PAR_LOSS_TOL and grad_err <= YX_PAR_GRAD_TOL
          and param_err <= 1.0 and stats_err <= YX_PAR_TOL,
          f"yolox fp32 step card vs CPU: loss {loss_err}, grads {grad_err}, params "
          f"{param_err}, BN statistics {stats_err}")

    # simOTA: a tie-free batch at 640^2 (continuous raw outputs, distinct GT centres)
    rs = np.random.RandomState(SEED + 8)
    outs = []
    for s in (8, 16, 32):
        h = 640 // s
        o = rs.randn(8, h, h, 26).astype(np.float32)
        o[..., 0:2] = rs.uniform(-0.5, 1.5, (8, h, h, 2))
        o[..., 2:4] = rs.normal(2.0, 0.8, (8, h, h, 2))
        outs.append(torch.from_numpy(o))
    gt = _yx_batch(8, 640, 21, rs, G=60, device="cpu")
    got = {}
    for dev in ("cuda", "cpu"):
        flat, grids, st = flatten_outputs([o.to(dev) for o in outs], (8, 16, 32))
        bd, ol, cl = decode_outputs(flat, grids, st)
        got[dev] = [t.cpu() for t in simota_assign(bd, ol, cl, grids, st, gt["gt_boxes"].to(dev),
                                                   gt["gt_labels"].to(dev),
                                                   gt["gt_valid"].to(dev))]
    n_fg = int(got["cpu"][0].sum())
    iou_err = float((got["cuda"][2] - got["cpu"][2]).abs().max())
    check(n_fg > 0 and torch.equal(got["cuda"][0], got["cpu"][0])
          and torch.equal(got["cuda"][1], got["cpu"][1]) and iou_err <= 1e-6,
          f"simOTA card vs CPU: fg / matched GT differ or IoU {iou_err}")
    log(f"[14/18] card vs CPU, TF32 off: one fp32 training step of a BN YOLOX (dep 0.33, wid "
        f"0.125, batch 2 at 128^2, Ranger): loss within {loss_err:.2e} relative (limit "
        f"{YX_PAR_LOSS_TOL}), gradients within {grad_err:.2e} (limit {YX_PAR_GRAD_TOL}), "
        f"BN statistics after the step within {stats_err:.2e} (limit {YX_PAR_TOL}) of each "
        f"tensor's largest, parameters at {param_err:.3f} of their allowance ({YX_PAR_TOL} of "
        f"their largest + 2 lr max|dgrad|); simOTA at 640^2 (batch 8, 60 padded "
        f"GTs, {n_fg} foreground anchors): fg and matched GT identical, matched IoU within "
        f"{iou_err:.1e}  [{card}]")
    return {"loss": loss_err, "grads": grad_err, "params_of_allowance": param_err,
            "bn_stats": stats_err,
            "simota_iou": iou_err}


def _two_class_records(root, rs, n=YX_LEARN_IMAGES):
    """n 160x120 images, each with two shapes (class 0: a larger square on
    the left, class 1: a smaller one on the right, each rotated, grey on
    black), as the cubes of tests/synth_utils.py look; DetRecords."""
    import cv2
    from gdrnpp_bop2022_torch.datasets.yolox_loader import DetRecord
    os.makedirs(root, exist_ok=True)
    recs = []
    for i in range(n):
        img = np.zeros((120, 160, 3), np.uint8)
        boxes = []
        for cx, half, grey in ((65.6, 7.2, 190), (92.0, 4.0, 178)):
            c = (cx + rs.uniform(-2.4, 2.4), 60.0 + rs.uniform(-4.8, 4.8))
            pts = cv2.boxPoints((c, (2 * half, 2 * half), float(rs.uniform(0, 90))))
            mask = np.zeros((120, 160), np.uint8)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
            img[mask > 0] = grey
            ys, xs = np.nonzero(mask)
            boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
        path = os.path.join(root, f"{i:06d}.png")
        cv2.imwrite(path, img)
        recs.append(DetRecord(path, boxes, [0, 1]))
    return recs


def _yx_learns(card, tmp):
    """yolox_s at 64^2 learns the two-class split: AP50 of the EMA weights."""
    from gdrnpp_bop2022_torch.datasets.yolox_loader import YoloxTrainLoader
    from gdrnpp_bop2022_torch.engine.yolox_trainer import train_yolox
    from gdrnpp_bop2022_torch.eval.detection_eval import evaluate_yolox_records
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    recs = _two_class_records(os.path.join(tmp, "two_class"), np.random.RandomState(SEED + 9))
    eval_model = build_yolox(2, "yolox_s", dtype=torch.float32)
    evals = []

    def eval_fn(weights, it):
        eval_model.load_state_dict(weights, strict=True)
        m = evaluate_yolox_records(eval_model, recs, 64, 2, conf_thr=0.05)
        evals.append((it, m["AP50"]))
        return m

    t0 = time.perf_counter()
    state = train_yolox(recs, 2, os.path.join(tmp, "yolox_learn"), size="yolox_s",
                        input_size=64, batch_size=8, total_iters=YX_LEARN_STEPS,
                        base_lr=0.02 / 64, no_aug_iters=10_000, multiscale_range=1,
                        log_period=50, ckpt_period=100, eval_fn=eval_fn, eval_period=100,
                        seed=0, loader=YoloxTrainLoader(recs, 8, 64, max_gt=16, seed=0))
    wall = time.perf_counter() - t0
    ap50 = max(a for _, a in evals)
    check(state.step == YX_LEARN_STEPS and ap50 >= YX_LEARN_AP50,
          f"yolox_s on the two-class split: AP50 {evals} (need {YX_LEARN_AP50})")
    log(f"[14/18] yolox_s (GN, bf16, SGD 0.02/64 per image, batch 8 at 64^2, L1 and clean "
        f"images throughout, multiscale +-1) learns {len(recs)} two-class images in "
        f"{YX_LEARN_STEPS} iterations ({wall:.1f} s): AP50 of the EMA weights "
        + ", ".join(f"{a:.3f} @ {it}" for it, a in evals)
        + f" (need {YX_LEARN_AP50}; the JAX package's test measured 0.67 @ 150)  [{card}]")
    del state, eval_model
    torch.cuda.empty_cache()
    return evals


def phase_detector_train(card, scene, tmp):
    """Phase 14: the recipe, the BN variant, card vs CPU, learning, and the
    trained checkpoint served by ``test_yolox --ckpt``."""
    t0 = time.perf_counter()
    rec, out = _yx_recipe(card, scene, tmp)
    bn_err = _yx_bn(card, scene, tmp)
    par = _yx_parity(card)
    evals = _yx_learns(card, tmp)
    root = os.path.dirname(os.path.dirname(scene["models_dir"]))    # holds ycbv/
    here = os.path.dirname(os.path.abspath(__file__))
    det_out = os.path.join(tmp, "yolox_trained_dets")
    t1 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "gdrnpp_bop2022_torch.tools.test_yolox",
                           "--config", "ycbv", "--root", root, "--ckpt",
                           os.path.join(out, "ckpt_yolox"), "--out", det_out],
                          capture_output=True, text=True, timeout=600, cwd=here)
    cli_s = time.perf_counter() - t1
    check(proc.returncode == 0, f"test_yolox --ckpt failed: {proc.stderr[-2000:]}")
    from gdrnpp_bop2022_torch.bop.inout import load_json
    handoff = load_json(os.path.join(det_out, "yolox_ycbv_test_bboxes.json"))
    n_rows = sum(len(v) for v in handoff.values())
    check(len(handoff) > 0 and all(np.isfinite(r["bbox_est"]).all() and 0 < r["score"] <= 1
                                   for v in handoff.values() for r in v),
          "test_yolox --ckpt's handoff json")
    check("WARNING" not in proc.stdout, "test_yolox --ckpt ran on random weights")
    m_ap = proc.stdout.strip().splitlines()[-1]
    log(f"[14/18] python -m gdrnpp_bop2022_torch.tools.test_yolox --config ycbv --ckpt "
        f"<out>/ckpt_yolox (the trained EMA weights, TTA): {len(handoff)} images, {n_rows} rows "
        f"in the handoff json, {m_ap} on the scene, {cli_s:.1f} s with the process start; "
        f"phase 14 in {time.perf_counter() - t0:.1f} s  [{card}]")
    return {"recipe": rec, "bn_update_err": bn_err, "parity": par,
            "learn_ap50": evals, "serve_rows": n_rows}


def _variant(card, tag, what, over, ln_per_fwd, rgbd, src, i, tmp):
    """One variant: serve the scene, time the forward, check the card
    against the CPU in fp32."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base_rgbd
    from gdrnpp_bop2022_torch.engine.batching import build_depth_rois, build_test_batch
    from gdrnpp_bop2022_torch.engine.inference import run_gdrn_inference
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict

    cfg = replace_cfg(ycbv_convnext_base_rgbd() if rgbd else Config(), over)
    pc = cfg.model.pose_net
    check(pc.num_classes == 21 and pc.input_res == 256 and cfg.model.compute_dtype == "bfloat16",
          f"{tag}: not at the flagship's width")
    t0 = time.perf_counter()
    model = build_gdrn(cfg)
    check(next(model.parameters()).is_cuda, f"{tag}: build_gdrn did not build on the card")
    model.load_state_dict(seeded_state_dict(model, VARIANT_SEED + i), strict=True)
    n_params = sum(p.numel() for p in model.parameters())
    forwards = [0]
    model.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    kw = dict(input_res=pc.input_res, output_res=pc.output_res,
              pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
              post_mode="direct", mask_loss_type=pc.loss.mask_loss_type,
              with_depth_input=rgbd, bp_depth=cfg.input.bp_depth,
              coord_2d_type=pc.pnp_net.coord_2d_type)
    stats = {}
    layer_norm.launches = 0                       # count this variant only
    results = run_gdrn_inference(model, src["batches"](), src["extents"], stats=stats, **kw)
    launches, n_fwd = layer_norm.launches, forwards[0]
    nb = stats["n_batches"]
    check(n_fwd == nb + 1, f"{tag}: {n_fwd} forwards for {nb} batches + warm-up")
    check(launches == ln_per_fwd * n_fwd,
          f"{tag}: layer_norm launches {launches} != {ln_per_fwd} x {n_fwd} forwards")
    orth = _check_rows(results, src["n_rois"], tmp, f"variant_{tag}")

    b0 = next(src["batches"]())
    dev = lambda a: torch.as_tensor(a).cuda()    # noqa: E731
    with torch.inference_mode():
        img_idx, Ks = dev(b0["img_idx"]), dev(b0["Ks"])
        rb = build_test_batch(dev(b0["images"]), img_idx, dev(b0["boxes_xyxy"]), Ks,
                              dev(b0["labels"]), dev(src["extents"]).float(),
                              input_res=pc.input_res, output_res=pc.output_res)
        if rgbd:
            rb["roi_depth"] = build_depth_rois(dev(b0["depths"]), img_idx, rb["roi_centers"],
                                               pc.output_res / rb["resize_ratios"], Ks,
                                               input_res=pc.input_res)
        fwd_ms = cuda_ms(lambda: model(**rb), iters=10)
        out = model(**rb)
        wall_ms, busy_ms, n_k, ev = profile_calls(lambda: model(**rb), VARIANT_PROFILE_CALLS)
    r = pc.output_res
    single = pc.geo_head.name != "top_down_doublemask_xyz_region"
    check(tuple(out["vis_mask"].shape) == (BATCH, r, r) and (out["full_mask"] is None) == single,
          f"{tag}: vis_mask {tuple(out['vis_mask'].shape)}, full_mask "
          f"{'None' if out['full_mask'] is None else tuple(out['full_mask'].shape)}")
    del model
    torch.cuda.empty_cache()
    f32 = replace_cfg(cfg, {"model.compute_dtype": "float32"})
    with no_tf32():
        errs = _parity(f32, {k: v[:2].float() if v.is_floating_point() else v[:2]
                             for k, v in rb.items()}, f"{tag} ({what})", "[15/18]")
    rec = {"what": what, "params_M": n_params / 1e6, "out_res": r, "rois": len(results),
           "forwards": n_fwd, "b1_launches": launches,
           "b1_per_forward": launches / n_fwd, "rois_per_sec": stats["rois_per_sec"],
           "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"], "fwd_ms": fwd_ms,
           "fwd_rois_per_sec": BATCH / fwd_ms * 1e3, "orth": orth, "parity": errs,
           "profile": {"wall_ms": wall_ms, "device_ms": busy_ms, "kernels": n_k,
                       "top": [(k[:60], ms, c) for k, ms, c in ev[:VARIANT_PROFILE_TOP]]},
           "seconds": time.perf_counter() - t0}
    log(f"[15/18] {tag} {what}: {n_params / 1e6:.2f} M parameters, output {r}^2; served "
        f"{len(results)} ROIs in {nb} batches of {BATCH} + warm-up: {n_fwd} forwards, "
        f"layer_norm launches {launches} = {ln_per_fwd} x {n_fwd}; rows finite, "
        f"max|R^T R - I| = {orth:.2e}; serving {stats['rois_per_sec']:.1f} ROI/s, p50 "
        f"{stats['p50_ms']:.2f} ms p99 {stats['p99_ms']:.2f} ms per batch; forward alone "
        f"{fwd_ms:.3f} ms = {BATCH / fwd_ms * 1e3:.1f} ROI/s (bf16, CUDA events); profiled "
        f"forward {wall_ms:.2f} ms wall, {busy_ms:.2f} ms of device time "
        f"({100 * busy_ms / wall_ms:.1f}% busy), {n_k} kernels and copies, top (ms, count): "
        + "; ".join(f"{k[:60]} {ms:.2f} ({c})" for k, ms, c in ev[:VARIANT_PROFILE_TOP])
        + f"; {rec['seconds']:.1f} s  [{card}]")
    return rec


def phase_variants(card, scene, bank, tmp):
    """Phase 15: the six GDRN variants V1-V6 at full width."""
    from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split, load_detections,
                                                        make_records_by_image)
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    t0 = time.perf_counter()
    # phase 4's RGB scene (the same seed), and the RGB-D scene with its depth
    meta, split_dir, det_file = _write_scene(os.path.join(tmp, "variants"),
                                             np.random.RandomState(SEED))
    by_im = make_records_by_image(index_bop_split(split_dir, meta))
    dets = load_detections(det_file, meta, top_k_per_obj=1)
    rgb = {"batches": lambda: iter_test_batches(by_im, dets, batch_size=BATCH),
           "extents": np.random.RandomState(SEED + 1).uniform(0.05, 0.25, (21, 3)),
           "n_rois": N_IMAGES * DETS_PER_IMAGE}
    dmeta = scene["meta"]
    d_by_im = make_records_by_image(index_bop_split(scene["split_dir"], dmeta))
    d_dets = load_detections(scene["det_file"], dmeta, top_k_per_obj=1)
    rgbd = {"batches": lambda: iter_test_batches(d_by_im, d_dets, batch_size=BATCH,
                                                 with_depth=True,
                                                 depth_factor=dmeta.depth_factor),
            "extents": bank.extents, "n_rois": N_IMAGES * DETS_PER_IMAGE}
    out = {}
    for i, (tag, what, over, ln_per_fwd, is_rgbd) in enumerate(VARIANTS):
        out[tag] = _variant(card, tag, what, over, ln_per_fwd, is_rgbd,
                            rgbd if is_rgbd else rgb, i, tmp)
    log(f"[15/18] phase 15 (variants V1-V6) in {time.perf_counter() - t0:.1f} s  [{card}]")
    return out


# ---------------------------------------------------------------------------
# the BOP sweep and the per-object path (phase 16)
# ---------------------------------------------------------------------------

def _quiet(fn, *args):
    """fn(*args) with its standard output kept: (result, the output)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def phase_sweep(card, scene, tmp):
    """Phase 16: python -m ...tools.run_bop_sweep over ycbv and lmo (yolox-x
    -> handoff json -> the convnext_base recipe -> scores, each stage a
    process of its own), lmo's GT poses scored as estimates (AR 1.0), then
    the per-object path: two ycbvSO configs
    served, their CSVs merged and their times normalised, the merged CSV
    scored; and strip_ckpt on phase 10's checkpoint, served like the
    checkpoint itself."""
    import re
    from gdrnpp_bop2022_torch.bop.inout import load_bop_results, load_json, save_bop_results
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.ops.raster import render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.tools import (merge_so_results, process_results_time, score_csv,
                                            strip_ckpt, test_gdrn)
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.dirname(scene["models_dir"]))    # holds ycbv/
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    lmo = make_rgbd_scene(os.path.join(root, "lmo"), np.random.RandomState(SEED + 16),
                          dataset="lmo", scene_id=LMO_SCENE)
    log(f"[16/18] lmo scene: {N_IMAGES} 480x640 RGB-D images x {len(lmo['meta'].id2obj)} "
        f"ellipsoids (lmo's {len(lmo['meta'].id2obj)} object ids and camera, analytic depth) in "
        f"{time.perf_counter() - t0:.1f} s")

    out = os.path.join(tmp, "sweep")
    cmd = [sys.executable, "-m", "gdrnpp_bop2022_torch.tools.run_bop_sweep",
           "--datasets", *SWEEP_DATASETS, "--root", root, "--mode", "eval",
           "--yolox-size", "yolox_x", "--yolox-input-size", "640", "--yolox-allow-random",
           "--gdrn-seed", str(SEED), "--out", out,
           "--opts", f"output_dir={os.path.join(tmp, 'sweep_gdrn_{ds}')!r}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=here)
    sweep_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"run_bop_sweep failed (rc {proc.returncode}): "
                                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    summary = load_json(os.path.join(out, "sweep_summary.json"))
    check(set(SWEEP_DATASETS) <= set(summary) and summary.get("mean_AR") is not None
          and np.isfinite(summary["mean_AR"]), f"sweep summary: {summary}")
    det_rates = re.findall(r"([0-9.]+) images/s in detection", proc.stdout)
    roi_rates = re.findall(r"batches of 64 \(direct, cuda(?::\d+)?\): ([0-9.]+) ROI/s",
                           proc.stdout)
    check(len(det_rates) == len(roi_rates) == len(SWEEP_DATASETS),
          f"the sweep's stages ran on the card? {proc.stdout[-2000:]}")
    per = {}
    for i, ds in enumerate(SWEEP_DATASETS):
        handoff = load_json(os.path.join(out, f"yolox_{ds}", f"yolox_{ds}_test_bboxes.json"))
        check(len(handoff) == N_IMAGES and all(
            0 < len(v) <= 100 and all(np.isfinite(r["bbox_est"]).all() for r in v)
            for v in handoff.values()), f"{ds}: the sweep's handoff json")
        inf = os.path.join(tmp, f"sweep_gdrn_{ds}", "inference", f"{ds}_test")
        scores, st = load_json(os.path.join(inf, "scores.json")), load_json(
            os.path.join(inf, "stats.json"))
        ar_keys = ("AR", "AR_vsd", "AR_mssd", "AR_mspd")
        check(all(0.0 <= scores[k] <= 1.0 for k in ar_keys) and scores["AR"] == summary[ds]["AR"],
              f"{ds}: scores {scores}")
        check(st["forwards"] >= 2 and st["launches"]["layer_norm"] == LN_PER_FORWARD * st["forwards"],
              f"{ds}: B1 launches in test_gdrn: {st}")
        check(st["launches"]["render_depth_xyz"] > 0, f"{ds}: B2 never ran in the scorer: {st}")
        per[ds] = {"handoff_rows": sum(len(v) for v in handoff.values()), "rois": st["n_rois"],
                   "forwards": st["forwards"], "b1_launches": st["launches"]["layer_norm"],
                   "b2_launches": st["launches"]["render_depth_xyz"],
                   "detect_images_per_s": float(det_rates[i]), "roi_per_s": float(roi_rates[i]),
                   **{k: scores[k] for k in ar_keys}}
        log(f"[16/18] sweep {ds}: test_yolox (yolox-x, bf16, random weights) {per[ds]['handoff_rows']} "
            f"rows in the handoff json, {det_rates[i]} images/s in detection; test_gdrn "
            f"({ds}_convnext_base, bf16, seed {SEED}) {st['n_rois']} ROIs at {roi_rates[i]} ROI/s, "
            f"{st['forwards']} forwards, B1 launches {st['launches']['layer_norm']} = 40 x "
            f"{st['forwards']}; scoring: B2 launches {st['launches']['render_depth_xyz']}; "
            + " ".join(f"{k}={scores[k]:.4f}" for k in ar_keys) + f"  [{card}]")
    log(f"[16/18] python -m gdrnpp_bop2022_torch.tools.run_bop_sweep --datasets "
        f"{' '.join(SWEEP_DATASETS)} --mode eval (4 stage processes): mean_AR "
        f"{summary['mean_AR']:.4f}, {sweep_s:.1f} s  [{card}]")

    # lmo's scoring path (its object ids, meta, VSD settings, B2 at its
    # camera) scores a correct pose as correct: the scene's GT poses as
    # estimates through score_csv --dataset lmo
    t0 = time.perf_counter()
    gt = load_json(os.path.join(lmo["split_dir"], f"{LMO_SCENE:06d}", "scene_gt.json"))
    gt_csv = os.path.join(tmp, "lmo_gt.csv")
    save_bop_results(gt_csv, [
        {"scene_id": LMO_SCENE, "im_id": int(im), "obj_id": g["obj_id"], "score": 1.0,
         "R": np.reshape(g["cam_R_m2c"], (3, 3)), "t": g["cam_t_m2c"], "time": 0.01}
        for im, gs in gt.items() for g in gs])
    render_depth_xyz_cuda.launches = 0
    lmo_gt, _ = _quiet(score_csv.main, ["--csv", gt_csv, "--dataset", "lmo", "--root", root])
    lmo_gt_b2 = render_depth_xyz_cuda.launches
    check(lmo_gt_b2 > 0 and all(lmo_gt[k] == 1.0 for k in ar_keys),
          f"lmo GT poses as estimates: B2 launches {lmo_gt_b2}, "
          f"{({k: lmo_gt[k] for k in ar_keys})}")
    log(f"[16/18] score_csv --dataset lmo on the lmo scene's GT poses as estimates "
        f"({sum(len(v) for v in gt.values())} rows): AR = AR_vsd = AR_mssd = AR_mspd = 1.0, "
        f"B2 launches {lmo_gt_b2}; {time.perf_counter() - t0:.1f} s  [{card}]")

    # the per-object path: one-class models with class-agnostic heads, each
    # serving every object's detections (nothing reads SO_OBJECT)
    t0 = time.perf_counter()
    n_rois = N_IMAGES * DETS_PER_IMAGE
    so_csvs, so_b1, so_fwd = [], 0, 0
    for obj in SO_OBJECTS:
        so_out = os.path.join(tmp, "so", obj)
        layer_norm.launches = 0                  # count this configuration only
        (results, _), _ = _quiet(test_gdrn.main, [
            "--config", f"ycbvSO/{obj}", "--seed", str(SEED), "--opts",
            f"datasets.root={root!r}", f"output_dir={so_out!r}",
            f"datasets.det_files_test=({scene['det_file']!r},)", "val.save_results_only=True"])
        launches = layer_norm.launches
        inf = os.path.join(so_out, "inference", "ycbv_test")
        st = load_json(os.path.join(inf, "stats.json"))
        check(st["n_rois"] == len(results) == n_rois and st["forwards"] >= 2
              and launches == st["launches"]["layer_norm"] == LN_PER_FORWARD * st["forwards"],
              f"ycbvSO/{obj}: {len(results)} rows, {launches} B1 launches, stats {st}")
        _check_rows(results, n_rois, tmp, f"so_{obj}")
        so_b1 += launches
        so_fwd += st["forwards"]
        so_csvs.append(os.path.join(inf, "poses.csv"))
    merged = os.path.join(tmp, "so", "merged.csv")
    n_merged, _ = _quiet(merge_so_results.main, [*so_csvs, "--out", merged])
    final = os.path.join(tmp, "so", "gdrn-ycbv-test.csv")
    _quiet(process_results_time.main, [final, merged])
    rows = load_bop_results(final)
    times = {}
    for r in rows:
        times.setdefault((r["scene_id"], r["im_id"]), set()).add(r["time"])
    check(len(rows) == len(SO_OBJECTS) * n_rois and all(len(v) == 1 for v in times.values()),
          f"merged SO CSV: {len(rows)} rows, per-image times {list(times.values())[:3]}")
    render_depth_xyz_cuda.launches = 0
    so_scores, _ = _quiet(score_csv.main, ["--csv", final, "--dataset", "ycbv", "--root", root])
    so_b2 = render_depth_xyz_cuda.launches
    check(so_b2 > 0 and all(0.0 <= so_scores[k] <= 1.0 for k in ("AR", "AR_vsd")),
          f"score_csv on the merged SO CSV: B2 launches {so_b2}, {so_scores}")
    so_s = time.perf_counter() - t0
    log(f"[16/18] per-object path: test_gdrn --config ycbvSO/{{{','.join(SO_OBJECTS)}}} (one "
        f"class, class-agnostic heads, bf16, seed {SEED}) {n_rois} ROIs each, {so_fwd} forwards, "
        f"B1 launches {so_b1} = 40 x {so_fwd}; merge_so_results {n_merged} rows, "
        f"process_results_time: one time per image over {len(times)} images; score_csv on the "
        f"merged CSV: B2 launches {so_b2}, AR={so_scores['AR']:.4f} AR_vsd="
        f"{so_scores['AR_vsd']:.4f}; {so_s:.1f} s  [{card}]")

    # strip_ckpt on phase 10's checkpoint: the released EMA weights serve
    # the poses the checkpoint serves
    t0 = time.perf_counter()
    ckpt_dir = os.path.join(tmp, "train_out", "ckpt")
    full = strip_ckpt.checkpoint_file(ckpt_dir)
    stripped, _ = _quiet(strip_ckpt.main, ["--ckpt", ckpt_dir, "--use-ema", "--out",
                                           os.path.join(tmp, "release", "model_wo_optim.pth")])
    poses = {}
    for tag, w in (("checkpoint", full), ("stripped", stripped)):
        (results, _), _ = _quiet(test_gdrn.main, [
            "--config", "ycbv_convnext_base", "--weights", w, "--opts", f"datasets.root={root!r}",
            f"output_dir={os.path.join(tmp, 'strip_' + tag)!r}",
            f"datasets.det_files_test=({scene['det_file']!r},)", "val.save_results_only=True"])
        _check_rows(results, n_rois, tmp, f"strip_{tag}")
        poses[tag] = (np.stack([r["R"] for r in results]), np.stack([r["t"] for r in results]))
    d = max(float(np.abs(a - b).max()) for a, b in zip(poses["checkpoint"], poses["stripped"]))
    check(d <= STRIP_POSE_TOL, f"stripped weights serve other poses: max diff {d}")
    log(f"[16/18] strip_ckpt --use-ema on phase 10's checkpoint ({os.path.getsize(full) / 1e6:.1f} "
        f"MB with the optimizer) -> {os.path.getsize(stripped) / 1e6:.1f} MB; test_gdrn --weights "
        f"on each serves {n_rois} ROIs, poses equal within {d:.2e}; {time.perf_counter() - t0:.1f} s")
    log(f"[16/18] phase 16 in {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return {"sweep": per, "mean_AR": summary["mean_AR"], "sweep_s": sweep_s,
            "b1_sweep": sum(p["b1_launches"] for p in per.values()),
            "b2_sweep": sum(p["b2_launches"] for p in per.values()),
            "lmo_gt_b2": lmo_gt_b2, "b1_so": so_b1, "b2_so": so_b2, "so_scores": {k: so_scores[k] for k in ("AR", "AR_vsd")},
            "so_s": so_s, "strip_pose_diff": d}


# ---------------------------------------------------------------------------
# export and the auxiliary ops (phase 17)
# ---------------------------------------------------------------------------

def phase_export(card, tmp):
    """python -m ...tools.export_model of the flagship Config() at batch 64
    with seeded weights, reloaded and run on the card: B1 launches per
    forward, the same poses as the eager model (bf16; and in fp32 with TF32
    off), its time beside the eager forward's."""
    import contextlib
    from gdrnpp_bop2022_torch.config import Config, parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    from gdrnpp_bop2022_torch.tools import export_model
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
    rec = {}
    for dtype, tol in (("bfloat16", EXPORT_BF16_TOL), ("float32", EXPORT_F32_TOL)):
        opts = [f"model.compute_dtype={dtype!r}"]
        out = os.path.join(tmp, f"export_{dtype}")
        with no_tf32() if dtype == "float32" else contextlib.nullcontext():
            t0 = time.perf_counter()
            res, _ = _quiet(export_model.main, [
                "--config", "default", "--seed", str(SEED), "--out", out,
                "--batch-size", str(BATCH), "--opts", *opts])
            export_s = time.perf_counter() - t0
            # the program as the CLI's self-check reloaded it from disk
            program, state = res["program"], res["state"]
            n_nodes = sum("gdrnpp.layer_norm" in str(n.target) for n in program.graph.nodes)
            cfg = replace_cfg(Config(), parse_opts(opts))
            inputs = export_model.example_inputs(cfg, BATCH, "cuda")
            model = build_gdrn(cfg)
            model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
            with torch.inference_mode():
                layer_norm.launches = 0            # one forward of the reloaded program
                rot, trans = program(state, *inputs)
                torch.cuda.synchronize()
                launches = layer_norm.launches
                ref = model(*inputs)
                d_rot = float((rot.float() - ref["rot"].float()).abs().max())
                d_t = float((trans.float() - ref["trans"].float()).abs().max())
                t_scale = float(ref["trans"].float().abs().max())
                times = {}
                if dtype == "bfloat16":        # in turns: eager, program, program, eager
                    for k, fn in (("eager", lambda: model(*inputs)),
                                  ("program", lambda: program(state, *inputs)),
                                  ("program2", lambda: program(state, *inputs)),
                                  ("eager2", lambda: model(*inputs))):
                        times[k] = cuda_ms(fn, iters=10)
                    for k, fn in (("eager", lambda: model(*inputs)),
                                  ("program", lambda: program(state, *inputs))):
                        wall, dev, n_k, ev = profile_calls(fn, 3)
                        times[f"{k}_profile"] = {"wall_ms": wall, "device_ms": dev, "kernels": n_k,
                                                 "top": [(e[:50], ms, c) for e, ms, c in ev[:5]]}
        check(n_nodes == LN_PER_FORWARD and launches == LN_PER_FORWARD,
              f"export {dtype}: {n_nodes} gdrnpp.layer_norm nodes, {launches} B1 launches a forward")
        check(torch.isfinite(rot).all() and torch.isfinite(trans).all() and d_rot <= tol
              and d_t <= tol * max(t_scale, 1.0),
              f"export {dtype}: reloaded vs eager rot {d_rot}, trans {d_t} (tol {tol})")
        size = os.path.getsize(os.path.join(out, export_model.PROGRAM)) / 1e6
        rec[dtype] = {"export_s": export_s, "program_mb": size, "b1_nodes": n_nodes,
                      "b1_launches": launches, "rot_diff": d_rot, "trans_diff": d_t, **times}
        log(f"[17/18] export_model --config default --batch-size {BATCH} ({dtype}"
            f"{', TF32 off' if dtype == 'float32' else ''}): traced, saved, reloaded and self-checked in {export_s:.1f} s, "
            f"{size:.1f} MB program + weights.pth; reloaded: {n_nodes} gdrnpp.layer_norm nodes, B1 "
            f"launches {launches} a forward; vs the eager model rot {d_rot:.2e}, trans {d_t:.2e} "
            f"(tol {tol:.3g})"
            + (f"; forward at batch {BATCH} (CUDA events, 10 calls, in turns): eager "
               f"{times['eager']:.3f} / {times['eager2']:.3f} ms, reloaded program "
               f"{times['program']:.3f} / {times['program2']:.3f} ms; profiled (3 calls): "
               + "; ".join(f"{k} {times[k + '_profile']['wall_ms']:.2f} ms wall, "
                           f"{times[k + '_profile']['device_ms']:.2f} ms device, "
                           f"{times[k + '_profile']['kernels']} kernels and copies, top "
                           + ", ".join(f"{e} {ms:.2f} ({c})"
                                       for e, ms, c in times[k + '_profile']['top'][:3])
                           for k in ("eager", "program")) if times else "")
            + f"  [{card}]")
        del program, state, model
        torch.cuda.empty_cache()
    return rec


def _canny_near(images, thr):
    """Pixels where canny_edges' decision is within CANNY_MARGIN of a
    boundary, recomputed in float64: the threshold, a direction bin's edge,
    or a tie with a neighbour's magnitude."""
    from gdrnpp_bop2022_torch.ops.edges import gauss_kernel, sep_blur, shift, sobel_gradients
    img = images.double()
    img = img.mean(dim=-1) if img.dim() == 4 else img
    gx, gy = sobel_gradients(sep_blur(img, gauss_kernel()))
    mag = torch.sqrt(gx * gx + gy * gy)
    a = torch.atan2(gy, gx) / (math.pi / 4)
    near = ((mag - thr).abs() <= CANNY_MARGIN * max(thr, 1.0)) | (
        ((a - a.floor()) - 0.5).abs() <= CANNY_MARGIN)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                near |= (mag - shift(mag, dy, dx)).abs() <= CANNY_MARGIN * mag.clamp_min(1.0)
    return near


def _aux_inputs(rs):
    """The auxiliary ops' inputs at their shapes, numpy, from rs."""
    n_pts, _ = FPS_SHAPE
    B, N, M = CHAMFER_SHAPE
    nb, H, W = AUX_IMAGES
    rb, rh, rw, nk, nh = RANSAC_SHAPE
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    depth = (0.8 + 0.3 * np.sin(xx / 90.0)[None] * np.cos(yy / 70.0)[None]
             + 0.05 * rs.rand(nb, H, W)).astype(np.float32)
    depth[:, :40] = 0.0                                  # invalid rows
    R_rel = []
    for _ in range(nb):                                  # up to ~6 degrees, Rodrigues
        ax = rs.randn(3)
        ax /= np.linalg.norm(ax)
        S = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        a = rs.uniform(0.0, 0.1)
        R_rel.append(np.eye(3) + np.sin(a) * S + (1 - np.cos(a)) * S @ S)
    R_rel = np.stack(R_rel)
    imgs = np.zeros((nb, H, W, 3), np.float32)
    for i in range(nb):
        for _ in range(12):
            cy, cx, r = rs.uniform(0, H), rs.uniform(0, W), rs.uniform(20, 120)
            imgs[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rs.uniform(0, 255, 3)
    imgs += rs.normal(0, 3, imgs.shape).astype(np.float32)
    ys, xs = np.mgrid[0:rh, 0:rw].astype(np.float32)
    mask = np.zeros((rb, rh, rw), np.float32)
    vertex = np.zeros((rb, rh, rw, nk, 2), np.float32)
    idx1 = np.zeros((rb, nk, nh), np.int64)
    idx2 = np.zeros_like(idx1)
    for i in range(rb):
        cy, cx, r = rs.uniform(150, rh - 150), rs.uniform(150, rw - 150), rs.uniform(50, 70)
        mask[i] = (ys - cy) ** 2 + (xs - cx) ** 2 < r * r
        for k in range(nk):
            kp = np.array([cx + rs.uniform(-100, 100), cy + rs.uniform(-100, 100)], np.float32)
            d = kp - np.stack([xs, ys], -1)
            d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-8)
            out = rs.rand(rh, rw) < 0.2                  # outlier votes
            ang = rs.uniform(0, 2 * np.pi, (rh, rw))
            d[out] = np.stack([np.cos(ang), np.sin(ang)], -1)[out]
            vertex[i, :, :, k] = d
            fg = np.flatnonzero(mask[i].ravel() > 0.5)
            idx1[i, k], idx2[i, k] = rs.choice(fg, nh), rs.choice(fg, nh)
    return {"fps": rs.uniform(-0.1, 0.1, (n_pts, 3)).astype(np.float32),
            "xyz1": rs.uniform(-0.1, 0.1, (B, N, 3)).astype(np.float32),
            "xyz2": rs.uniform(-0.1, 0.1, (B, M, 3)).astype(np.float32),
            "mask2": rs.rand(B, M) > 0.1,
            "depth": depth, "K": np.tile(K, (nb, 1, 1)), "R_rel": R_rel.astype(np.float32),
            "t_rel": rs.uniform(-0.02, 0.02, (nb, 3)).astype(np.float32), "imgs": imgs,
            "mask": mask, "vertex": vertex, "idx1": idx1, "idx2": idx2}


def phase_aux(card):
    """Each auxiliary op on the card against the CPU on the same inputs
    (fp32, TF32 off), timed by CUDA events; the RLE codec through its native
    library against its numpy path."""
    from gdrnpp_bop2022_torch.ops.chamfer import chamfer_distance
    from gdrnpp_bop2022_torch.ops.edges import canny_edges
    from gdrnpp_bop2022_torch.ops.flow import flow_from_depth
    from gdrnpp_bop2022_torch.ops.fps import fps_indices
    from gdrnpp_bop2022_torch.ops.ransac_voting import ransac_voting_layer
    from gdrnpp_bop2022_torch.utils import mask_rle
    t_phase = time.perf_counter()
    inp = _aux_inputs(np.random.RandomState(SEED + 17))
    gpu = {k: torch.from_numpy(v).cuda() for k, v in inp.items()}
    cpu = {k: torch.from_numpy(v) for k, v in inp.items()}
    rec = {}

    def record(name, ms, cpu_s, err, what, n_bytes, n_ops):
        """n_bytes: inputs read once and outputs written once; n_ops: the
        plain algorithm's fp32 operations on these inputs."""
        b_s, o_s = n_bytes / H100_BYTES_PER_S, n_ops / H100_FP32_FLOPS
        rec[name] = {"ms": ms, "cpu_s": cpu_s, "err": err, "bound_ms": max(b_s, o_s) * 1e3,
                     "bound_by": "bytes" if b_s >= o_s else "operations"}
        log(f"[17/18] {name} {what}: card {ms:.3f} ms (CUDA events), bound "
            f"{rec[name]['bound_ms']:.4f} ms ({rec[name]['bound_by']}), the CPU {cpu_s:.2f} s "
            f"(host clock); card vs CPU: {err}  [{card}]")

    with no_tf32(), torch.inference_mode():
        k = FPS_SHAPE[1]
        g = fps_indices(gpu["fps"], k)
        t0 = time.perf_counter()
        c = fps_indices(cpu["fps"], k)
        cpu_s = time.perf_counter() - t0
        check(torch.equal(g.cpu(), c), "fps: the card's indices differ from the CPU's")
        n = FPS_SHAPE[0]
        record("fps", cuda_ms(lambda: fps_indices(gpu["fps"], k), iters=5), cpu_s,
               "indices equal", f"K = {k} of {n} points",
               n * 12 + k * 8, (k - 1) * n * 10)       # per step and point: 3 sub, 3 mul, 2 add, min, max

        args = (gpu["xyz1"], gpu["xyz2"], None, gpu["mask2"])
        g = [v.cpu() for v in chamfer_distance(*args)]
        t0 = time.perf_counter()
        c = chamfer_distance(cpu["xyz1"], cpu["xyz2"], None, cpu["mask2"])
        cpu_s = time.perf_counter() - t0
        # d = |a|^2 + |b|^2 - 2 a.b rounds at the scale of the squared norms
        scale = float(max((cpu["xyz1"] ** 2).sum(-1).max(), (cpu["xyz2"] ** 2).sum(-1).max()))
        worst = 0.0
        for (dg, ig, dc, ic) in ((g[0], g[1], c[0], c[1]), (g[2], g[3], c[2], c[3])):
            tol = CHAMFER_REL_TOL * torch.maximum(dc.abs(), torch.tensor(scale))
            check(((dg - dc).abs() <= tol).all(), "chamfer: distances differ")
            worst = max(worst, float(((dg - dc).abs() / tol).max()))
            check(((ig == ic) | ((dg - dc).abs() <= tol)).all(), "chamfer: indices differ")
        n_idx = int((g[1] != c[1]).sum() + (g[3] != c[3]).sum())
        B, N, M = CHAMFER_SHAPE
        record("chamfer", cuda_ms(lambda: chamfer_distance(*args), iters=5), cpu_s,
               f"distances within {worst:.2f} of the tolerance, {n_idx} indices differ at "
               f"equal distances", f"{B} x {N} x {M}",
               B * (N + M) * 12 + B * M + B * (N + M) * 12,
               B * N * M * 10)                        # a.b 5, |a|^2 + |b|^2 - 2 a.b 3, two mins

        fargs = (gpu["depth"], gpu["K"], gpu["R_rel"], gpu["t_rel"])
        fg, vg = flow_from_depth(*fargs)
        t0 = time.perf_counter()
        fc, vc = flow_from_depth(cpu["depth"], cpu["K"], cpu["R_rel"], cpu["t_rel"])
        cpu_s = time.perf_counter() - t0
        err = float((fg.cpu() - fc).abs().max())
        check(torch.equal(vg.cpu(), vc) and err <= FLOW_TOL, f"flow: max diff {err} px")
        px = int(np.prod(AUX_IMAGES))
        record("flow", cuda_ms(lambda: flow_from_depth(*fargs), iters=10), cpu_s,
               f"max {err:.2e} px", f"{AUX_IMAGES[0]} x {AUX_IMAGES[1]}x{AUX_IMAGES[2]}",
               px * (4 + 8 + 1), px * 30)             # backproject 6, rotate 15, project 8, test 1

        thr = 10.0
        eg = canny_edges(gpu["imgs"], thr).cpu()
        t0 = time.perf_counter()
        ec = canny_edges(cpu["imgs"], thr)
        cpu_s = time.perf_counter() - t0
        diff = eg != ec
        n_diff = int(diff.sum())
        check(not (diff & ~_canny_near(cpu["imgs"], thr)).any(),
              f"canny: {n_diff} pixels differ, some away from every decision boundary")
        record("canny", cuda_ms(lambda: canny_edges(gpu["imgs"], thr), iters=10), cpu_s,
               f"{n_diff} of {ec.numel()} pixels differ, each within {CANNY_MARGIN} of a "
               f"decision boundary; {int(ec.sum())} edge pixels",
               f"{AUX_IMAGES[0]} x {AUX_IMAGES[1]}x{AUX_IMAGES[2]} RGB",
               px * (12 + 1), px * 70)    # gray 3, blur 18, Sobel 16, mag 3, angle ~20, NMS ~10

        rb, rh, rw, nk, nh = RANSAC_SHAPE
        rargs = (gpu["mask"], gpu["vertex"], nh)
        rkw = {"idx1": gpu["idx1"], "idx2": gpu["idx2"]}
        pg = ransac_voting_layer(*rargs, **rkw).cpu()
        n = RANSAC_CPU_IMAGES
        t0 = time.perf_counter()
        pc = ransac_voting_layer(cpu["mask"][:n], cpu["vertex"][:n], nh,
                                 idx1=cpu["idx1"][:n], idx2=cpu["idx2"][:n])
        cpu_s = time.perf_counter() - t0
        err = float((pg[:n] - pc).abs().max())
        check(torch.isfinite(pg).all() and err <= RANSAC_TOL, f"ransac voting: max diff {err} px")
        record("ransac_voting", cuda_ms(lambda: ransac_voting_layer(*rargs, **rkw), iters=3,
                                        warmup=1), cpu_s,
               f"max {err:.2e} px on the CPU's {n} image(s) x {RANSAC_SHAPE[3]} keypoints",
               f"{RANSAC_SHAPE[0]} x {RANSAC_SHAPE[1]}x{RANSAC_SHAPE[2]} x {RANSAC_SHAPE[3]} "
               f"keypoints x {nh} hypotheses, fixed draws",
               rb * rh * rw * (nk * 8 + 4) + 2 * rb * nk * nh * 8 + rb * nk * 8,
               rb * nk * nh * rh * rw * 12)    # a hypothesis x pixel: diff 2, norm 5, cos 3, test 2

    rs = np.random.RandomState(SEED + 18)
    yy, xx = np.mgrid[0:AUX_IMAGES[1], 0:AUX_IMAGES[2]]
    masks = [(yy - rs.uniform(0, 480)) ** 2 / rs.uniform(20, 150) ** 2
             + (xx - rs.uniform(0, 640)) ** 2 / rs.uniform(20, 150) ** 2
             + 0.2 * rs.rand(*yy.shape) < 1.0 for _ in range(RLE_MASKS)]
    check(mask_rle.native_loaded(), "the RLE codec's native library did not load")
    t0 = time.perf_counter()
    enc = [mask_rle.encode(m) for m in masks]
    dec = [mask_rle.decode(e) for e in enc]
    native_ms = (time.perf_counter() - t0) * 1e3 / len(masks)
    lib = mask_rle._LIB
    mask_rle._LIB = None                       # the numpy path
    try:
        t0 = time.perf_counter()
        enc_np = [mask_rle.encode(m) for m in masks]
        numpy_ms = (time.perf_counter() - t0) * 1e3 / len(masks)
    finally:
        mask_rle._LIB = lib
    check(all(np.array_equal(d, m) for d, m in zip(dec, masks))
          and [e["counts"] for e in enc] == [e["counts"] for e in enc_np],
          "RLE: round trip or native vs numpy bytes differ")
    rec["rle"] = {"native_ms": native_ms, "numpy_ms": numpy_ms}
    log(f"[17/18] RLE codec (native/rle.cpp built with g++): {len(masks)} masks of "
        f"{masks[0].shape[0]}x{masks[0].shape[1]}, round trip exact, bytes equal to the numpy "
        f"path; encode + decode {native_ms:.3f} ms a mask native, encode {numpy_ms:.3f} ms "
        f"numpy (host clock)")
    log(f"[17/18] auxiliary ops in {time.perf_counter() - t_phase:.1f} s  [{card}]")
    return rec


def _parity(cfg, batch, tag, phase="[9/18]"):
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
        check((k in gpu) == (k in cpu), f"{tag}: {k} is None on one device only")
        if k not in gpu:        # a single-mask head's full_mask
            continue
        d = float((gpu[k] - cpu[k]).abs().max())
        scale = max(float(cpu[k].abs().max()), 1.0)
        errs[k] = d
        tol = PARITY_ROT_TOL if k == "rot" else PARITY_REL_TOL * scale
        check(torch.isfinite(gpu[k]).all() and d <= tol,
              f"{tag} card vs CPU {k}: max abs diff {d} > {tol}")
    log(f"{phase} fp32 {tag}, 2 ROIs, card (its kernels) vs CPU (plain versions), TF32 "
        "off: max abs diff " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    return errs


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


def opt_ema_times(card):
    """One Ranger + EMA step as train_gdrn runs it, over the flagship
    model's parameters (configs.ycbv_convnext_base()) with seeded gradients:
    ms per step by CUDA events around OPT_STEPS back-to-back steps (the
    host's enqueue included, as the trainer's optimizer + EMA mark reads it)
    and the device time of one step's kernels (profiler)."""
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
    cfg = ycbv_convnext_base()
    torch.manual_seed(SEED)
    model = build_gdrn(cfg, train=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 14)
    for p in model.parameters():
        p.grad = 1e-3 * torch.randn(p.shape, device="cuda", generator=g)
    state = create_train_state(model, build_optimizer(cfg, cfg.solver.base_lr, model),
                               cfg.model.ema_decay, cfg.model.ema_warmup_updates)

    def step():
        state.optimizer.step()
        state.step += 1
        state.update_ema()

    t = {"ms": cuda_ms(step, iters=OPT_STEPS, warmup=3), "device_ms": device_ms(step),
         "params": sum(1 for _ in model.parameters())}
    # where the host's time goes (the profiler's own cost per op included)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(OPT_STEPS):
            step()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    t["host_ms"] = sum(e.self_cpu_time_total for e in ops) / OPT_STEPS / 1e3
    t["host_top"] = [(e.key, e.self_cpu_time_total / OPT_STEPS / 1e3, e.count / OPT_STEPS)
                     for e in ops[:12]]
    log(f"Ranger + EMA step over the flagship's {t['params']} parameters: "
        f"{t['ms']:.2f} ms by events, {t['device_ms']:.2f} ms of kernels; host ops "
        f"{t['host_ms']:.2f} ms a step under the profiler, top (self ms, calls a step): "
        + "; ".join(f"{k} {ms:.2f} ({c:.0f})" for k, ms, c in t["host_top"]) + f"  [{card}]")
    del state, model
    torch.cuda.empty_cache()
    return t


# ---------------------------------------------------------------------------
# phase 18: int8 serving, remat, the demo's depth refine, data parallelism
# ---------------------------------------------------------------------------

def _block_int8_accs(blk, x):
    """The int8 accumulators of one ConvNeXt block's two MLP products on its
    input x (NCHW), as the block computes them, each held to an int32
    matmul of the same codes on the CPU (its first INT8_CPU_ROWS rows) and
    to a float64 product of them on the card (all rows; exact: |acc| <
    127^2 K < 2^53)."""
    from gdrnpp_bop2022_torch.models.backbones.convnext import (dense_int8, int8_codes,
                                                                int8_matmul)
    from gdrnpp_bop2022_torch.models.layers import conv2d
    h = conv2d(blk.conv_dw, x, blk.dtype)
    h = blk.norm.forward_nhwc(h.contiguous(memory_format=torch.channels_last)
                              .permute(0, 2, 3, 1)).to(blk.dtype)
    out = []
    for fc in (blk.mlp.fc1, blk.mlp.fc2):
        h2 = h.reshape(-1, h.shape[-1])
        xq, _, wq, _ = int8_codes(h2, fc.weight)
        acc = int8_matmul(xq, wq)
        check(acc.is_cuda and acc.dtype == torch.int32, "int8 accumulators not int32 on the card")
        n = INT8_CPU_ROWS
        cpu = xq[:n].cpu().int() @ wq.cpu().int().T
        check(torch.equal(acc[:n].cpu(), cpu), "torch._int_mm != the CPU's int32 matmul")
        full = xq.double() @ wq.double().T
        check(torch.equal(acc.double(), full), "torch._int_mm != the exact product")
        out.append((tuple(xq.shape), tuple(wq.shape), int(acc.abs().max())))
        h = blk.act(dense_int8(h, fc.weight, fc.bias)) if fc is blk.mlp.fc1 else h
    return out


def _pose_diff(a, b):
    """Max rotation angle (deg) and translation (cm) between two outputs."""
    from gdrnpp_bop2022_torch.geometry.rotations import angular_distance
    ang = angular_distance(a["rot"].float(), b["rot"].float()) * (180.0 / math.pi)
    dt = torch.linalg.vector_norm(a["trans"].float() - b["trans"].float(), dim=-1) * 100.0
    return float(ang.max()), float(ang.mean()), float(dt.max()), float(dt.mean())


def phase_int8(card, serve):
    """(a) the flagship with backbone.int8_mlp=True on phase 4's batch of 64
    ROIs, the same weights as the bf16 model: one block's int8 accumulators
    exact, the poses' difference from bf16, forward times in turns, B1's
    launches a forward."""
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm
    m16, rb = serve["model"], serve["rb"]
    m8 = build_gdrn(replace_cfg(Config(), {"model.pose_net.backbone.int8_mlp": True}))
    m8.load_state_dict(m16.state_dict(), strict=True)
    blk = m8.backbone.stages[INT8_BLOCK[0]].blocks[INT8_BLOCK[1]]
    check(blk.int8_mlp and not m8.training, "the int8 model does not serve int8 MLPs")
    seen, body = {}, blk.body            # the stage calls each block's body

    def spy(x, mask=None):
        seen.setdefault("x", x)
        return body(x, mask)
    blk.body = spy
    with torch.inference_mode():
        layer_norm.launches = 0
        out8 = m8(**rb)
        torch.cuda.synchronize()
        launches = layer_norm.launches
        del blk.body
        out16 = m16(**rb)
        accs = _block_int8_accs(blk, seen["x"])
        for k in ("rot", "trans", "coor_x", "region"):
            check(bool(torch.isfinite(out8[k]).all()), f"int8 {k} not finite")
        diff = _pose_diff(out8, out16)
        t16a = cuda_ms(lambda: m16(**rb), iters=10)
        t8a = cuda_ms(lambda: m8(**rb), iters=10)
        t8b = cuda_ms(lambda: m8(**rb), iters=10)
        t16b = cuda_ms(lambda: m16(**rb), iters=10)
    check(launches == LN_PER_FORWARD, f"int8 forward: {launches} B1 launches, not 40")
    log(f"[18/18] int8 MLPs (Config(), backbone.int8_mlp=True, batch {BATCH}, bf16 elsewhere): "
        f"stage {INT8_BLOCK[0]} block {INT8_BLOCK[1]}'s torch._int_mm accumulators "
        f"{accs} equal the CPU's int32 matmul of the same codes ({INT8_CPU_ROWS} rows) "
        f"and the exact product (all rows); B1 {launches} launches a forward  [{card}]")
    log(f"[18/18] int8 vs bf16 poses on the same 64 ROIs (seeded weights): rotation max "
        f"{diff[0]:.3f} deg mean {diff[1]:.3f} deg, translation max {diff[2]:.3f} cm mean "
        f"{diff[3]:.3f} cm  [{card}]")
    log(f"[18/18] forward at batch {BATCH} (CUDA events, 10 calls, in turns bf16 int8 int8 bf16): "
        f"bf16 {t16a:.3f} / {t16b:.3f} ms, int8 {t8a:.3f} / {t8b:.3f} ms  [{card}]")
    del m8
    return {"b1_launches": launches, "bf16_ms": [t16a, t16b], "int8_ms": [t8a, t8b],
            "rot_max_deg": diff[0], "rot_mean_deg": diff[1], "t_max_cm": diff[2],
            "t_mean_cm": diff[3], "accumulators": accs}


def _remat_run(cfg, batches, bnk, remat):
    """REMAT_STEPS train steps of cfg (remat on or off) on the given
    batches from the seed's weights: losses, B1 launches, peak memory, step
    times (CUDA events)."""
    from gdrnpp_bop2022_torch.config import replace_cfg
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.train_step import make_train_step
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.models.layers import DropMasks
    from gdrnpp_bop2022_torch.ops.layer_norm import layer_norm, layer_norm_backward
    from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
    cfg = replace_cfg(cfg, {"model.pose_net.backbone.remat": remat})
    torch.manual_seed(cfg.train.seed)
    model = build_gdrn(cfg, train=True)
    check(all(st.remat == remat for st in model.backbone.stages), "remat not built")
    state = create_train_state(model, build_optimizer(cfg, lambda s: REMAT_LR, model),
                               ema_decay=cfg.model.ema_decay)
    step = make_train_step(cfg, bnk["sym_bank"], bnk["sym_mask"])
    drop = DropMasks(gen=torch.Generator(device="cuda").manual_seed(SEED))
    losses, ms, fwd, bwd = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for b in batches:
        layer_norm.launches = layer_norm_backward.launches = 0
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        m = step(state, b, drop=drop)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["total_loss"]))
        fwd.append(layer_norm.launches)
        bwd.append(layer_norm_backward.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, model
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "fwd": fwd, "bwd": bwd, "peak_gb": peak}


def phase_remat(card, ctx):
    """(b) the RGB recipe at batch 48 for REMAT_STEPS steps with and without
    backbone.remat on the same batches: the losses, B1's forward launches
    (76 against 40 a step; backward 40), peak memory and step times."""
    from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base
    from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
    from gdrnpp_bop2022_torch.engine.trainer import device_bank, prep_train_batch
    cfg = replace_cfg(ycbv_convnext_base(), parse_opts(ctx["common"]))
    meta, pc = ctx["meta"], cfg.model.pose_net
    bnk = device_bank(ctx["bank"], pc.geo_head.num_regions, "cuda")
    loader = GdrnTrainLoader(ctx["records"], TRAIN_BATCH, meta.width, meta.height,
                             seed=SEED + 40, num_workers=1)
    try:
        batches = [prep_train_batch(next(loader), bnk, cfg, "cuda") for _ in range(REMAT_STEPS)]
    finally:
        loader.close()
    off = _remat_run(cfg, batches, bnk, False)
    on = _remat_run(cfg, batches, bnk, True)
    check(off["losses"][0] == on["losses"][0], f"remat step 1 loss {on['losses'][0]} != "
          f"{off['losses'][0]}")
    for a, b in zip(off["losses"], on["losses"]):
        check(abs(a - b) <= REMAT_LOSS_TOL * abs(a), f"remat losses {on['losses']} vs "
              f"{off['losses']}")
    check(off["fwd"] == [LN_PER_FORWARD] * REMAT_STEPS and off["bwd"] == off["fwd"],
          f"B1 without remat: {off['fwd']} forward, {off['bwd']} backward launches a step")
    check(on["fwd"] == [REMAT_LN_FWD] * REMAT_STEPS and on["bwd"] == off["bwd"],
          f"B1 with remat: {on['fwd']} forward, {on['bwd']} backward launches a step")
    check(on["peak_gb"] < off["peak_gb"], f"remat peak {on['peak_gb']:.2f} GB not below "
          f"{off['peak_gb']:.2f} GB")
    p50 = lambda v: float(np.median(v[1:]))     # noqa: E731  (step 1 warms up)
    log(f"[18/18] remat: configs.ycbv_convnext_base() at batch {TRAIN_BATCH}, {REMAT_STEPS} "
        f"steps on the same batches (lr {REMAT_LR}): losses without "
        f"{[round(v, 6) for v in off['losses']]} with {[round(v, 6) for v in on['losses']]}; "
        f"B1 forward launches a step {off['fwd'][0]} -> {on['fwd'][0]}, backward "
        f"{off['bwd'][0]} -> {on['bwd'][0]}; peak max_memory_allocated "
        f"{off['peak_gb']:.2f} -> {on['peak_gb']:.2f} GB; step p50 (CUDA events, steps 2..) "
        f"{p50(off['ms']):.1f} -> {p50(on['ms']):.1f} ms  [{card}]")
    return {"off": off, "on": on, "launches": sum(on["fwd"])}


def phase_demo_refine(card, scene, tmp):
    """(c) demo_gdrn --dets --depth-images --depth-refine --cam-K on the RGB-D
    scene (the flagship RGB model, seeded) against run_gdrn_inference(
    post_mode="depth_refine") on the same detections, and B2's launches."""
    from gdrnpp_bop2022_torch.bop.inout import load_json, save_json
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    from gdrnpp_bop2022_torch.config import Config
    from gdrnpp_bop2022_torch.datasets.bop_data import (index_bop_split, load_detections,
                                                        make_records_by_image)
    from gdrnpp_bop2022_torch.datasets.test_loader import iter_test_batches
    from gdrnpp_bop2022_torch.engine.inference import run_gdrn_inference
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.ops.raster import pack_faces_cuda, render_depth_xyz_cuda
    from gdrnpp_bop2022_torch.tools import demo_gdrn
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
    sdir = os.path.join(scene["split_dir"], "000048")
    dets_json = os.path.join(tmp, "demo_dets.json")
    save_json(dets_json, {f"{int(k.split('/')[1]):06d}": v
                          for k, v in load_json(scene["det_file"]).items()})
    root = os.path.dirname(os.path.dirname(scene["models_dir"]))
    t0 = time.perf_counter()
    render_depth_xyz_cuda.launches = pack_faces_cuda.launches = 0
    (rows, written), _ = _quiet(demo_gdrn.main, [
        "--config", "default", "--seed", str(SEED), "--images", os.path.join(sdir, "rgb", "*.png"),
        "--dets", dets_json, "--depth-images", os.path.join(sdir, "depth", "*.png"),
        "--depth-scale", "10000", "--depth-refine", "--cam-K",
        *[str(v) for v in scene["K"].ravel()], "--out", os.path.join(tmp, "demo_refine"),
        "--opts", f"datasets.root={root!r}"])
    demo_s = time.perf_counter() - t0
    launches = {"raster": render_depth_xyz_cuda.launches, "pack": pack_faces_cuda.launches}
    cfg = Config()
    pc = cfg.model.pose_net
    model = build_gdrn(cfg)
    model.load_state_dict(seeded_state_dict(model, SEED), strict=True)
    meta = scene["meta"]
    bank = ModelBank.from_bop_models_dir(scene["models_dir"], num_fps=pc.geo_head.num_regions)
    by_im = make_records_by_image(index_bop_split(scene["split_dir"], meta))
    want = run_gdrn_inference(
        model, iter_test_batches(by_im, load_detections(scene["det_file"], meta),
                                 batch_size=BATCH, with_depth=True,
                                 depth_factor=meta.depth_factor),
        bank.extents, input_res=pc.input_res, output_res=pc.output_res,
        pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
        post_mode="depth_refine", model_bank=bank, mask_loss_type=pc.loss.mask_loss_type)
    key = lambda r: (r["im_id"], r["obj_id"])     # noqa: E731
    got, exp = sorted(rows, key=key), sorted(want, key=key)
    check(len(got) == len(exp) == N_IMAGES * DETS_PER_IMAGE and
          [key(r) for r in got] == [key(r) for r in exp], "demo rows != run_gdrn_inference's rows")
    dt = max(float(np.abs(g["t"] - w["t"]).max()) for g, w in zip(got, exp))
    dR = max(float(np.abs(g["R"] - w["R"]).max()) for g, w in zip(got, exp))
    check(dt <= DEMO_REFINE_T_TOL and dR <= DEMO_REFINE_T_TOL,
          f"demo depth refine vs run_gdrn_inference: |dt| {dt:.3e} m |dR| {dR:.3e}")
    check(launches["raster"] > 0 and len(written) == N_IMAGES, f"demo: {launches}, "
          f"{len(written)} images drawn")
    log(f"[18/18] demo_gdrn --dets --depth-images --depth-scale 10000 --depth-refine --cam-K "
        f"(flagship RGB, seeded) on the RGB-D scene's {N_IMAGES} images: {len(got)} poses, "
        f"translations within {dt:.2e} m and R within {dR:.2e} of run_gdrn_inference("
        f"post_mode='depth_refine') on the same detections; B2 {launches['raster']} raster + "
        f"{launches['pack']} pack launches; {demo_s:.1f} s  [{card}]")
    del model
    return {"launches": launches["raster"], "pack_launches": launches["pack"], "t_diff_m": dt,
            "rows": len(got)}


def _spawn_ranks(module, args, world, out_dir, timeout=600):
    """``world`` processes of ``python -m module args --num-processes world
    --process-id r --coordinator localhost:port`` (gloo, all on this card);
    waits for each and fails if one did."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = []
    for r in range(world):
        log_f = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", module, *args, "--num-processes", str(world),
             "--process-id", str(r), "--coordinator", f"localhost:{port}",
             "--dist-backend", "gloo"], stdout=log_f, stderr=subprocess.STDOUT, cwd=here), log_f))
    try:
        for p, f in procs:
            p.wait(timeout=timeout)
            f.close()
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                check(False, f"{module} rank {r} failed: {f.read()[-3000:]}")


def _ckpt_params(out_dir):
    from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    step = mgr.latest_step()
    check(step == DDP_STEPS, f"{out_dir}: checkpoint of step {step}")
    return torch.load(mgr.path(step), map_location="cpu", weights_only=False)["model"]


def _first_loss(out_dir):
    with open(os.path.join(out_dir, "metrics.json")) as f:
        rows = [json.loads(line) for line in f]
    return next(r["total_loss"] for r in rows if r.get("iteration") == 1)


def phase_ddp(card, ctx, scene, tmp):
    """(d) train_gdrn at world 1 (one process) and at world 2 (two processes
    over gloo on this one card, NCCL refusing two ranks on one device) for
    DDP_STEPS steps of the RGB recipe; test_gdrn over two processes against
    one."""
    from gdrnpp_bop2022_torch.config import parse_opts, replace_cfg
    from gdrnpp_bop2022_torch.configs import ycbv_convnext_base
    from gdrnpp_bop2022_torch.engine.trainer import train_gdrn
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    opts = ctx["common"] + [f"train.log_period=1", "solver.checkpoint_period_epochs=1000"]
    out1, out2 = os.path.join(tmp, "ddp_w1"), os.path.join(tmp, "ddp_w2")
    os.makedirs(out2)
    cfg1 = replace_cfg(ycbv_convnext_base(), parse_opts(opts + [f"output_dir={out1!r}"]))
    torch.manual_seed(cfg1.train.seed)
    init = {k: v.detach().cpu().clone() for k, v in build_gdrn(cfg1, train=True)
            .state_dict().items()}
    t0 = time.perf_counter()
    _quiet(train_gdrn, cfg1, ctx["records"], ctx["bank"], None, DDP_STEPS, False, ctx["meta"])
    w1_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _spawn_ranks("gdrnpp_bop2022_torch.tools.train_gdrn",
                 ["--config", "ycbv_convnext_base", "--max-iters", str(DDP_STEPS),
                  "--device", "cuda:0", "--opts", *opts, f"output_dir={out2!r}"],
                 DDP_WORLD, out2)
    w2_s = time.perf_counter() - t0
    p1, p2 = _ckpt_params(out1), _ckpt_params(out2)
    num = den = 0.0
    worst = 0.0
    for k, v in init.items():
        if not v.is_floating_point() or "running" in k:
            continue
        d1, d2 = p1[k].float() - v.float(), p2[k].float() - v.float()
        num += float((d2 - d1).square().sum())
        den += float(d1.square().sum())
        worst = max(worst, float((p2[k] - p1[k]).abs().max()))
    rel = math.sqrt(num / max(den, 1e-30))
    l1, l2 = _first_loss(out1), _first_loss(out2)
    stats = [json.load(open(os.path.join(out2, f"stats_rank{r}.json"))) for r in range(DDP_WORLD)]
    check(all(s["world"] == DDP_WORLD and s["steps"] == DDP_STEPS for s in stats),
          f"world-2 stats {stats}")
    b1 = [s["launches"]["layer_norm"] for s in stats]
    b2 = [s["launches"]["render_depth_xyz"] for s in stats]
    check(all(n == LN_PER_FORWARD * DDP_STEPS for n in b1) and all(n == DDP_STEPS for n in b2),
          f"world-2 launches a rank: B1 {b1}, B2 {b2}")
    check(abs(l2 - l1) <= DDP_LOSS_TOL * abs(l1), f"step-1 loss world 2 {l2} vs world 1 {l1}")
    check(rel <= DDP_UPDATE_TOL, f"world 2's parameter updates differ from world 1's by "
          f"{rel:.3e} of their norm")
    log(f"[18/18] DDP: train_gdrn (configs.ycbv_convnext_base(), global batch {TRAIN_BATCH}, "
        f"{DDP_STEPS} steps) at world 1 ({w1_s:.1f} s in process) and world 2 (two processes "
        f"over gloo on this card, {TRAIN_BATCH // DDP_WORLD} ROIs a rank, {w2_s:.1f} s with "
        f"the process starts): step-1 loss {l1:.6f} vs {l2:.6f} (mean over the ranks); "
        f"parameter updates differ by {rel:.3e} of their L2 norm (max |dp| {worst:.3e}); "
        f"per rank B1 {b1[0]} forward launches, B2 {b2[0]} (each rank renders the global "
        f"batch's XYZ), peak {stats[0]['peak_gb']:.2f} GB a rank. What DDP gains needs "
        f"several cards: not measured  [{card}]")

    # test_gdrn over two processes against one
    root = os.path.dirname(os.path.dirname(scene["models_dir"]))
    base = ["--config", "default", "--seed", str(SEED), "--opts", f"datasets.root={root!r}",
            "model.load_dets_test=True", f"datasets.det_files_test=({scene['det_file']!r},)",
            "val.save_results_only=True"]
    one, two = os.path.join(tmp, "tg_one"), os.path.join(tmp, "tg_two")
    os.makedirs(two)
    from gdrnpp_bop2022_torch.tools import test_gdrn
    _quiet(test_gdrn.main, base + [f"output_dir={one!r}"])
    t0 = time.perf_counter()
    _spawn_ranks("gdrnpp_bop2022_torch.tools.test_gdrn", base + [f"output_dir={two!r}"],
                 DDP_WORLD, two)
    tg_s = time.perf_counter() - t0
    from gdrnpp_bop2022_torch.bop.inout import load_bop_results
    inf = os.path.join("inference", "ycbv_test")
    r1 = {(r["scene_id"], r["im_id"], r["obj_id"]): r
          for r in load_bop_results(os.path.join(one, inf, "poses.csv"))}
    r2 = {(r["scene_id"], r["im_id"], r["obj_id"]): r
          for r in load_bop_results(os.path.join(two, inf, "poses.csv"))}
    check(r1.keys() == r2.keys() and len(r1) == N_IMAGES * DETS_PER_IMAGE,
          f"test_gdrn rows: {len(r1)} vs {len(r2)}")
    dR = max(float(np.abs(np.asarray(r1[k]["R"]) - np.asarray(r2[k]["R"])).max()) for k in r1)
    dt = max(float(np.abs(np.asarray(r1[k]["t"]) - np.asarray(r2[k]["t"])).max()) for k in r1)
    check(dR <= DDP_EVAL_R_TOL and dt <= DDP_EVAL_T_TOL_MM,
          f"test_gdrn two processes vs one: |dR| {dR:.3e}, |dt| {dt:.3e} mm")
    with open(os.path.join(two, inf, "stats.json")) as f:
        st = json.load(f)
    log(f"[18/18] test_gdrn --num-processes 2 on this card (images dealt round-robin, rows "
        f"gathered over gloo): {len(r2)} rows = one process's, |dR| {dR:.2e}, |dt| {dt:.2e} mm; "
        f"B1 {st['launches']['layer_norm']} launches over {st['forwards']} forwards; "
        f"{tg_s:.1f} s with the process starts  [{card}]")
    return {"loss_w1": l1, "loss_w2": l2, "update_rel": rel, "b1_per_rank": b1[0],
            "b2_per_rank": b2[0], "launches": sum(b1), "raster_launches": sum(b2),
            "eval_dR": dR, "eval_dt_mm": dt}

def timing_only(root):
    """B1's and B2's times at the flagship shapes for the package under
    `root`, through the wrappers every version has, and where the package
    trains, B1's backward and a Ranger + EMA step; the last line is JSON."""
    sys.path.insert(0, os.path.abspath(root))
    import gdrnpp_bop2022_torch
    from gdrnpp_bop2022_torch.bop.models3d import ModelBank
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    pkg = os.path.dirname(os.path.abspath(gdrnpp_bop2022_torch.__file__))
    log(f"timing {pkg}")
    _, card = phase_device(ptxas=False)     # an earlier tree keeps no build log
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
    rec = {"package": pkg, "card": card,
           "b1": {k: ln[k] for k in ("ms", "cold_ms", "library_ms", "library_cold_ms",
                                     "copy_cold_ms", "bound_ms")},
           "b2": b2}
    if os.path.exists(os.path.join(pkg, "solver", "ranger.py")):
        rec["b1_backward"] = ln_backward_times(card)
        rec["opt_ema"] = opt_ema_times(card)
    print(json.dumps(rec))
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
        scene = make_rgbd_scene(os.path.join(tmp, "ycbv"), np.random.RandomState(SEED + 2))
        bank = ModelBank.from_bop_models_dir(scene["models_dir"])
        check(bank.faces.shape == (21, 4096, 3), f"bank faces {bank.faces.shape}")
        log(f"[3/18] RGB-D scene and model bank written and loaded in "
            f"{time.perf_counter() - t0:.1f} s (analytic depth, no rendering)")
        b2 = phase_raster(card, scene, bank)
        rb, serve = phase_slice(card, os.path.join(tmp, "rgb"))
        ln_launches, r_launches, rb_rgbd, times = phase_rgbd_slice(card, scene, bank, tmp)
        phase_refine(card, scene, bank)
        pnp = phase_pnp(card, scene, bank, serve, tmp)
        p18 = {"int8": phase_int8(card, serve)}
        del serve
        score = phase_score(card, scene, bank, tmp)
        train = phase_train(card, scene, tmp)
        pool = phase_pool(card, train["ctx"])
        rgbd = phase_train_rgbd(card, train["ctx"])
        ctx = train.pop("ctx")
        lnb = train["lnb"]
        torch.cuda.empty_cache()
        det = phase_detector(card, scene)
        two = phase_two_stage(card, scene, tmp)
        det_train = phase_detector_train(card, scene, tmp)
        variants = phase_variants(card, scene, bank, tmp)
        torch.cuda.empty_cache()
        sweep = phase_sweep(card, scene, tmp)
        t17 = time.perf_counter()
        export = phase_export(card, tmp)
        aux = phase_aux(card)
        log(f"[17/18] phase 17 in {time.perf_counter() - t17:.1f} s  [{card}]")
        t18 = time.perf_counter()
        p18["remat"] = phase_remat(card, ctx)
        p18["demo"] = phase_demo_refine(card, scene, tmp)
        p18["ddp"] = phase_ddp(card, ctx, scene, tmp)
        log(f"[18/18] phase 18 in {time.perf_counter() - t18:.1f} s (+ its int8 part after "
            f"phase 7)  [{card}]")
    share = 100.0 * 2 * b2["ms"] / times["p50_ms"]
    log(f"[5/18] B2 share of an RGB-D batch: 2 calls x {b2['ms']:.4f} ms of a "
        f"{times['p50_ms']:.2f} ms p50 batch = {share:.2f}%  [{card}]")
    phase_parity(rb, rb_rgbd)
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "gdrnpp_bop2022_tpu"))
    check(not bad, f"the port imported {bad[:3]}")
    log("detector and two-stage: " + json.dumps({"detector": det, "two_stage": two}))
    log("detector training: " + json.dumps(det_train))
    log("variants: " + json.dumps(variants) + f"  [{card}]")
    log("sweep, per-object path and strip: " + json.dumps(sweep) + f"  [{card}]")
    log("export and auxiliary ops: " + json.dumps({"export": export, "aux": aux})
        + f"  [{card}]")
    log("int8, remat, demo depth refine and data parallelism: " + json.dumps(p18)
        + f"  [{card}]")
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "layer_norm", "route": "cuda",
         "source": "gdrnpp_bop2022_torch/csrc/layer_norm.cu",
         "replaces": "gdrnpp_bop2022_tpu/ops/pallas_ln.py:26",
         "launches": ln_launches, "max_abs_err": ln["max_abs_err"], "ms": ln["ms"],
         "cold_ms": ln["cold_ms"], "plain_ms": ln["plain_ms"], "bound_ms": ln["bound_ms"],
         "bound_by": ln["bound_by"], "library_ms": ln["library_ms"],
         "launches_by_path": {"rgbd_depth_refine": ln_launches,
                              **{f"rgb_{m}": pnp[m]["launches"] for m in PNP_MODES},
                              "train": train["launches"]["fwd"],
                              "train_rgbd": rgbd["launches"]["fwd"],
                              "two_stage": two["launches"],
                              "variants": sum(v["b1_launches"] for v in variants.values()),
                              "sweep": sweep["b1_sweep"], "so": sweep["b1_so"],
                              "export": export["bfloat16"]["b1_launches"],
                              "int8_serving": p18["int8"]["b1_launches"],
                              "remat_train": p18["remat"]["launches"],
                              "ddp_train": p18["ddp"]["launches"]}},
        {"name": "layer_norm_backward", "route": "cuda",
         "source": "gdrnpp_bop2022_torch/csrc/layer_norm.cu",
         "replaces": "gdrnpp_bop2022_tpu/ops/pallas_ln.py:26 (its VJP)",
         "launches": train["launches"]["bwd"],
         "reduce_launches": train["launches"]["reduce"],
         "max_abs_err": lnb["max_abs_err"], "ms": lnb["ms"], "cold_ms": lnb["cold_ms"],
         "plain_ms": lnb["plain_ms"], "bound_ms": lnb["bound_ms"], "bound_by": lnb["bound_by"],
         "library_ms": lnb["library_ms"], "copy_cold_ms": lnb["copy_cold_ms"],
         "fwd_stats_cold_ms": lnb["fwd_stats_cold_ms"],
         "fwd_stats_bound_ms": lnb["fwd_stats_bound_ms"], "per_width": lnb["shapes"],
         "ptxas": PTXAS_BACKWARD,
         "launches_by_path": {"train": train["launches"]["bwd"],
                              "train_rgbd": rgbd["launches"]["bwd"]}},
        {"name": "render_depth_xyz", "route": "cuda",
         "source": "gdrnpp_bop2022_torch/csrc/raster.cu",
         "replaces": "gdrnpp_bop2022_tpu/ops/pallas_raster.py:53",
         "launches": r_launches, "max_abs_err": b2["max_abs_err"], "ms": b2["ms"],
         "cold_ms": b2["cold_ms"], "plain_ms": b2["plain_ms"], "bound_ms": b2["bound_ms"],
         "bound_by": b2["bound_by"], "all_pairs_bound_ms": b2["all_pairs_bound_ms"],
         "library_ms": None,
         "launches_by_path": {"rgbd_depth_refine": r_launches, "scoring": score["launches"],
                              "train": train["launches"]["raster"],
                              "train_rgbd": rgbd["launches"]["raster"],
                              "sweep_scoring": sweep["b2_sweep"], "so_scoring": sweep["b2_so"],
                              "demo_depth_refine": p18["demo"]["launches"],
                              "ddp_train": p18["ddp"]["raster_launches"]},
         "vsd_shapes": b2["vsd_shapes"], "train_attribute_mode": train["b2"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
