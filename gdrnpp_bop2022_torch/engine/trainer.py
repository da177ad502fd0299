"""GDRN training: the do_train loop, on one card or one process per card.

Port of ``gdrnpp_bop2022_tpu/engine/trainer.py`` (reference
GDRN_Lite.do_train, core/gdrn_modeling/engine/engine.py:166-420) for
stacked host batches:

  BOP records -> ``GdrnTrainLoader`` (host threads: decode, DZI jitter,
  backgrounds, truncation draws; or slots into ``FramePools`` on the
  device) -> ``prep_train_batch`` on the card, in the JAX package's order:
  background replacement, colour augmentation, ``build_train_batch_online``
  (crops, kernel B2's depth + XYZ render, masks, regions, SITE targets),
  the truncation folded into gt_mask_trunc where the background was
  replaced, and for RGB-D the depth augmentation and depth ROIs ->
  ``make_train_step`` (bf16 forward, B1 forward and backward kernels,
  drop_path / DropBlock, the GDRN losses, the optimizer, the EMA) ->
  ``metrics.json`` + TensorBoard scalars and checkpoints.

Every random draw of a step comes from the trainer's generators, one per
purpose (bg, color, depth, dropout), seeded from ``cfg.train.seed`` and
kept in checkpoints. Only the log period reads metrics back to the host.
Offline XYZ (``xyz_online=False``) raises, as in the JAX package.

Data parallel (``cfg.train.mesh_shape`` / ``mesh_axes`` over the ranks of
``parallel.initialize_distributed``, one process per card): every rank
loads and prepares the same global batch with the same draws, trains on
its slice (``parallel.shard_batch``; drop masks drawn for the global batch
and sliced), averages the gradients before clipping and the optimizer, and
so holds the same parameters and EMA; the loss of a step is the global
batch's, as under the JAX mesh. Only rank 0 writes metrics (averaged over
the ranks), checkpoints and evaluations.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..datasets.meta import get_meta
from ..datasets.train_loader import GdrnTrainLoader
from ..models.gdrn import build_gdrn
from ..models.layers import DropMasks
from ..ops.color_aug import apply_color_aug, draw_color_aug, draw_replace_background, \
    replace_background
from ..ops.crop import roi_crop_resize
from ..ops.depth_aug import draw_gdrn_depth_aug, gdrn_depth_aug
from ..parallel.distributed import broadcast_module, is_main_process, mean_over_ranks
from ..parallel.mesh import make_mesh, shard_batch
from ..solver.lr_scheduler import build_lr_scheduler, flat_and_anneal_schedule
from ..solver.ranger import build_optimizer
from .batching import build_depth_rois, build_train_batch_online, trunc_mask_batch
from .checkpoint import CheckpointManager
from .train_state import create_train_state
from .train_step import make_train_step


class MetricsWriter:
    """Console + metrics.json + TensorBoard scalars (reference
    my_writer.py:120,268 and :53; here a dependency-free tfevents stream)."""

    def __init__(self, output_dir: str, max_iter: int, log_period: int = 20,
                 tensorboard: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.json")
        self.max_iter = max_iter
        self.log_period = log_period
        self._t_start = time.perf_counter()
        self._t_last = self._t_start
        self._last_iter = 0
        self.tb = None
        if tensorboard:
            from ..utils.tb_writer import TensorBoardWriter
            self.tb = TensorBoardWriter(os.path.join(output_dir, "tb"))

    def write(self, iteration: int, metrics: dict, lr: float,
              data_wait_ms: Optional[float] = None):
        """metrics: name -> number or 0-d tensor (read here, the only host
        read of a step). data_wait_ms: mean host time per step blocked on
        the loader since the last write."""
        row = {k: float(v) for k, v in metrics.items()}
        row["iteration"] = iteration
        row["lr"] = float(lr)
        now = time.perf_counter()
        n_win = max(iteration - self._last_iter, 1)
        row["iters_per_sec"] = n_win / max(now - self._t_last, 1e-9)
        self._t_last, self._last_iter = now, iteration
        if data_wait_ms is not None:
            row["data_wait_ms"] = float(data_wait_ms)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        if self.tb is not None:
            self.tb.add_scalars({k: v for k, v in row.items() if k != "iteration"}, iteration)
            self.tb.flush()
        elapsed = time.perf_counter() - self._t_start
        done = max(iteration, 1)
        eta = elapsed / done * (self.max_iter - done)
        wait = f" wait {row['data_wait_ms']:.1f}ms" if "data_wait_ms" in row else ""
        print(f"iter {iteration}/{self.max_iter} "
              f"loss {row.get('total_loss', float('nan')):.4f} "
              f"eR {row.get('error_R_deg', float('nan')):.2f}deg "
              f"et {row.get('error_t_cm', float('nan')):.2f}cm "
              f"lr {lr:.2e} {row['iters_per_sec']:.2f}it/s{wait} "
              f"eta {eta / 60:.1f}min", flush=True)


class StepTimer:
    """CUDA events at named marks of each step (``begin`` starts a step);
    inert on the CPU. ``summary()`` synchronises once at the end."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.steps = []

    def begin(self):
        if self.enabled:
            self.steps.append([])
            self.mark("start")

    def mark(self, name: str):
        if self.enabled:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.steps[-1].append((name, ev))

    def summary(self) -> dict:
        """Per step: ms from each mark to the next (keyed by the later
        mark's name), and ``step`` = start to the next step's start."""
        if not self.steps:
            return {}
        torch.cuda.synchronize()
        out = {}
        for i, marks in enumerate(self.steps):
            for (_, a), (name, b) in zip(marks, marks[1:]):
                out.setdefault(name, []).append(a.elapsed_time(b))
            if i + 1 < len(self.steps):
                out.setdefault("step", []).append(marks[0][1].elapsed_time(self.steps[i + 1][0][1]))
        return out


def check_config(cfg: Config) -> None:
    """Raise on what the trainer does not do: offline XYZ ground truth
    (``xyz_online=False``), which the JAX package's trainer refuses too:
    the ground truth is rendered on the device every step."""
    if not cfg.model.pose_net.xyz_online:
        raise NotImplementedError(
            "pose_net.xyz_online=False (offline pre-generated XYZ files) is not supported: "
            "the XYZ and depth ground truth is rendered on the device every step "
            "(build_train_batch_online); set xyz_online=True")


GENERATORS = ("bg", "color", "depth", "dropout")


def make_generators(seed: int, device) -> dict:
    """One torch.Generator per purpose on ``device``, each seeded from
    ``seed`` (purpose i: 8 seed + i + 1)."""
    return {name: torch.Generator(device=device).manual_seed(8 * seed + i + 1)
            for i, name in enumerate(GENERATORS)}


def bg_image_paths(cfg: Config):
    """The background images of ``input.bg_images_dir`` (jpg / jpeg / png,
    recursively), or None without background replacement. A configured
    directory without images raises: training without them would be
    another recipe."""
    inp = cfg.input
    if not (inp.change_bg_prob > 0 and inp.bg_images_dir):
        return None
    paths = sorted(p for ext in ("*.jpg", "*.jpeg", "*.png")
                   for p in glob.glob(os.path.join(inp.bg_images_dir, "**", ext),
                                      recursive=True))
    if not paths:
        raise FileNotFoundError(f"input.bg_images_dir={inp.bg_images_dir!r} holds no "
                                ".jpg, .jpeg or .png image")
    return paths


def device_bank(model_bank, num_regions: int, device) -> dict:
    """The model bank's arrays the online batch and the losses read, on device."""
    t = lambda a: torch.as_tensor(np.asarray(a)).to(device)    # noqa: E731
    sym_bank, sym_mask = model_bank.sym_bank()
    return {"verts": t(model_bank.verts).float(), "faces": t(model_bank.faces),
            "fps_points": t(model_bank.fps_points[:, :num_regions]).float(),
            "extents": t(model_bank.extents).float(), "points": t(model_bank.points).float(),
            "sym_bank": sym_bank.to(device), "sym_mask": sym_mask.to(device)}


def _mark(timer, name):
    if timer is not None:
        timer.mark(name)


def _frames(host_batch: dict, d: dict, cfg: Config, device) -> dict:
    """The batch's frames on the device: images / img_idx, the stacks the
    masks are cropped from (mask_visib, mask_full) with their indices
    (mask_idx, mask_full_idx), fg_masks and bg_images (with backgrounds),
    depths / depth_idx (with depth). A pool batch gathers its images (and
    foreground masks and backgrounds) from its snapshot of the pools once
    its uploads are done; its masks and depth stay in the pools, indexed
    by slot."""
    with_depth = cfg.input.with_depth
    if "pool_bufs" not in host_batch:
        return {"images": d["images"], "img_idx": d["img_idx"], "mask_visib": d["mask_visib"],
                "mask_full": d["mask_full"], "mask_idx": d["mask_idx"], "mask_full_idx": None,
                "fg_masks": d.get("fg_masks"), "bg_images": d.get("bg_images"),
                "depths": d["depths"] if with_depth else None, "depth_idx": d["img_idx"]}
    bufs = host_batch["pool_bufs"]
    if bufs["ready"] is not None:
        torch.cuda.current_stream(device).wait_event(bufs["ready"])
    f = {"images": bufs["rgb"][d["img_idx"].long()], "mask_visib": bufs["mask"],
         "mask_full": bufs["mask"], "mask_idx": d["mask_idx"],
         "mask_full_idx": d["mask_full_idx"], "fg_masks": None, "bg_images": None,
         "depths": bufs["depth"] if with_depth else None,
         "depth_idx": d["depth_idx"] if with_depth else None}
    f["img_idx"] = torch.arange(f["images"].shape[0], device=f["images"].device)
    if "bg_idx" in d:
        f["fg_masks"] = bufs["mask"][d["mask_idx"].long()].float()
        if cfg.input.truncate_fg and "trunc_draws" in d:
            f["fg_masks"] = trunc_mask_batch(f["fg_masks"], d["trunc_draws"])
        f["bg_images"] = bufs["bg"][d["bg_idx"].long()]
    return f


def prep_train_batch(host_batch: dict, bank: dict, cfg: Config, device, gens=None,
                     timer=None) -> dict:
    """A host batch of the loader (stacked, or slots into frame pools) ->
    the training batch on ``device``, in the JAX package's order
    (engine/trainer.py:188-308): background replacement, colour
    augmentation, ``build_train_batch_online`` plus the PM loss's model
    points, the foreground truncation folded into gt_mask_trunc where the
    background was replaced, and with depth the depth augmentation and
    ``roi_depth``. ``gens``: the trainer's generators; without them no
    augmentation is drawn (a batch held apart to evaluate on). A pool
    batch is released to the pools once every read of it is enqueued.
    ``timer.mark`` is called after the host-to-device copies ("h2d"), the
    augmentations ("aug"), the online batch ("batch") and, with depth, the
    depth ROIs ("depth")."""
    pc, inp = cfg.model.pose_net, cfg.input
    d = {k: torch.as_tensor(v).to(device) for k, v in host_batch.items()
         if k not in ("pool_bufs", "pool_mode")}
    f = _frames(host_batch, d, cfg, device)
    images, fg_masks, depths, depth_idx = f["images"], f["fg_masks"], f["depths"], f["depth_idx"]
    _mark(timer, "h2d")
    bg_gate = None
    if gens is not None and inp.change_bg_prob > 0 and f["bg_images"] is not None:
        draws = draw_replace_background(gens["bg"], images.shape[0], f["bg_images"].shape[0],
                                        inp.change_bg_prob)
        images, bg_gate = replace_background(images.float(), fg_masks, f["bg_images"], draws)
    if gens is not None and inp.color_aug.prob > 0:
        draws = draw_color_aug(gens["color"], tuple(images.shape), inp.color_aug.aug_type,
                               inp.color_aug.prob)
        images = apply_color_aug(images, draws, inp.color_aug.aug_type)
    _mark(timer, "aug")
    batch = build_train_batch_online(
        images, f["img_idx"], d["centers"], d["scales"], d["bboxes_xyxy"], d["Ks"],
        d["labels"], d["gt_rots"], d["gt_transes"], f["mask_visib"], f["mask_full"],
        f["mask_idx"], bank["verts"], bank["faces"], bank["fps_points"], bank["extents"],
        input_res=pc.input_res, output_res=pc.output_res,
        pixel_mean=tuple(cfg.model.pixel_mean), pixel_std=tuple(cfg.model.pixel_std),
        xyz_bin=pc.geo_head.xyz_num_bins if pc.loss.xyz_loss_type == "CE_coor" else 0,
        mask_full_idx=f["mask_full_idx"], coord_2d_type=pc.pnp_net.coord_2d_type,
        xyz_bp=pc.xyz_bp)
    batch["gt_points"] = bank["points"][batch["roi_labels"]]
    if inp.truncate_fg and fg_masks is not None and bg_gate is not None:
        # reference mask_trunc = mask_visib * trunc_mask (data_loader.py:522-532),
        # only where the background was replaced: an image left as it is
        # still shows the whole object
        tm = roi_crop_resize(fg_masks[..., None], d["centers"], d["scales"], pc.output_res,
                             method="nearest")[..., 0]
        tm = torch.where(bg_gate[:, None, None] > 0, tm, torch.ones_like(tm))
        batch["gt_mask_trunc"] = batch["gt_mask_trunc"] * tm
    _mark(timer, "batch")
    if inp.with_depth:
        if gens is not None and inp.depth_aug:
            if "pool_bufs" in host_batch:       # augment the gathered frames, not the pool
                depths = depths[depth_idx.long()]
                depth_idx = torch.arange(depths.shape[0], device=depths.device)
            draws = draw_gdrn_depth_aug(
                gens["depth"], tuple(depths.shape), drop_prob=inp.drop_depth_prob,
                drop_ratio=inp.drop_depth_ratio, noise_prob=inp.add_noise_depth_prob,
                noise_level=inp.add_noise_depth_level)
            depths = gdrn_depth_aug(depths, draws)
        batch["roi_depth"] = build_depth_rois(depths, depth_idx, d["centers"], d["scales"],
                                              d["Ks"], input_res=pc.input_res,
                                              bp_depth=inp.bp_depth)
        _mark(timer, "depth")
    if "pool_bufs" in host_batch:
        host_batch["pool_bufs"]["release"]()
    return batch


def _load_pretrained_backbone(model, path: str) -> None:
    """``backbone.pretrained`` into model.backbone (``utils/weights.py::
    load_pretrained_backbone``: a timm ConvNeXt checkpoint, the stem
    adapted to ``backbone.in_channels``, or an ``.npz`` of flax paths);
    every backbone parameter must be in it."""
    from ..utils.weights import load_pretrained_backbone
    bb = model.cfg.backbone
    model.backbone.load_state_dict(
        load_pretrained_backbone(path, model.backbone, bb.name, bb.in_channels), strict=True)
    print(f"loaded pretrained backbone from {path}", flush=True)


def train_gdrn(cfg: Config, records, model_bank, records2=None,
               max_iters: Optional[int] = None, resume: bool = True, meta=None,
               eval_fn=None, device="cuda", stats: Optional[dict] = None):
    """Train GDRN on ``device`` (the card unless the caller asks for the
    CPU). records: InstanceRecord list; model_bank: ModelBank; meta:
    DatasetMeta (from cfg.datasets.train when omitted); eval_fn:
    callable(state, iteration) -> dict, run every cfg.train.eval_period
    iterations, its results appended to metrics.json. With ``stats`` (a
    dict), fills in per-step device times of each phase (CUDA events, on
    the card), host waits on the loader and, with frame pools, their
    ``stats()`` under "pool". Returns the TrainState."""
    check_config(cfg)
    device = torch.device(device)
    if meta is None and cfg.datasets.train:
        meta = get_meta(cfg.datasets.train[0])
    im_w = meta.width if meta else 640
    im_h = meta.height if meta else 480
    pc, sc = cfg.model.pose_net, cfg.solver

    iters_per_epoch = max(len(records) // sc.ims_per_batch, 1)
    total_iters = max_iters or sc.total_epochs * iters_per_epoch
    mesh = make_mesh(cfg.train.mesh_shape, cfg.train.mesh_axes)
    main = is_main_process()
    torch.manual_seed(cfg.train.seed)
    model = build_gdrn(cfg, device=device, train=True)
    if pc.backbone.pretrained:
        _load_pretrained_backbone(model, pc.backbone.pretrained)
    broadcast_module(model)
    # the schedule spans the run actually made (max_iters overrides epochs)
    if sc.lr_scheduler == "flat_and_anneal":
        sched = flat_and_anneal_schedule(
            base_lr=sc.base_lr, total_iters=total_iters, warmup_iters=sc.warmup_iters,
            warmup_factor=sc.warmup_factor, warmup_method=sc.warmup_method,
            anneal_point=sc.anneal_point, anneal_method=sc.anneal_method)
    else:
        sched = build_lr_scheduler(cfg, iters_per_epoch)
    state = create_train_state(model, build_optimizer(cfg, sched, model),
                               ema_decay=cfg.model.ema_decay,
                               ema_warmup=cfg.model.ema_warmup_updates)
    state.generators = make_generators(cfg.train.seed, device)
    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"), max_to_keep=sc.max_to_keep)
    if resume and ckpt.restore_latest(state) is not None and main:
        print(f"resumed from iter {state.step}", flush=True)
    start_iter = state.step

    bank = device_bank(model_bank, pc.geo_head.num_regions, device)
    step_fn = make_train_step(cfg, bank["sym_bank"], bank["sym_mask"])
    writer = (MetricsWriter(cfg.output_dir, total_iters, cfg.train.log_period,
                            tensorboard=cfg.train.tensorboard) if main else None)
    ckpt_period = max(sc.checkpoint_period_epochs * iters_per_epoch, 1)
    timer = StepTimer(enabled=stats is not None and device.type == "cuda")
    waits = []

    inp, tc = cfg.input, cfg.train
    bg_paths = bg_image_paths(cfg)
    pools = None
    if tc.device_pool_frames > 0:
        from ..datasets.device_pool import FramePools
        pools = FramePools(im_h, im_w, rgb_frames=tc.device_pool_frames,
                           mask_frames=tc.device_pool_mask_frames or 2 * tc.device_pool_frames,
                           depth_frames=tc.device_pool_frames if inp.with_depth else 0,
                           bg_frames=tc.device_pool_bg_frames if bg_paths else 0, device=device)
        print(f"device frame pools: {pools.nbytes / 1e9:.2f} GB on {device}", flush=True)
    loader = GdrnTrainLoader(
        records, sc.ims_per_batch, im_w, im_h, records2=records2,
        ratio2=cfg.datasets.train2_ratio, dzi_pad_scale=inp.dzi_pad_scale,
        dzi_scale_ratio=inp.dzi_scale_ratio, dzi_shift_ratio=inp.dzi_shift_ratio,
        dzi_type=inp.dzi_type, bbox_type=cfg.model.bbox_type, seed=tc.seed,
        bg_paths=bg_paths, truncate_fg=inp.truncate_fg, with_depth=inp.with_depth,
        sampler=cfg.datasets.sampler, repeat_thresh=cfg.datasets.repeat_thresh,
        num_workers=tc.num_workers, num_builders=1 if pools is not None else tc.num_builders,
        cache_gb=tc.cache_gb, pools=pools)
    gens = state.generators
    drop = DropMasks(gen=gens["dropout"], shard=(mesh.index, mesh.size))
    try:
        t_w = time.perf_counter()
        host_batch = next(loader)
        waits.append(time.perf_counter() - t_w)
        data_wait_s = waits[-1]
        for it in range(start_iter, total_iters):
            timer.begin()
            batch = shard_batch(prep_train_batch(host_batch, bank, cfg, device, gens=gens,
                                                 timer=timer), mesh)
            metrics = step_fn(state, batch, timer, drop=drop,
                              progress=float(np.float32(it / max(total_iters, 1))))
            if (it + 1) % cfg.train.log_period == 0 or it == start_iter:
                metrics = mean_over_ranks(metrics)
                n_win = (it - start_iter) % cfg.train.log_period + 1
                if main:
                    writer.write(it + 1, metrics, sched(it),
                                 data_wait_ms=data_wait_s / n_win * 1000.0)
                data_wait_s = 0.0
            if main and ((it + 1) % ckpt_period == 0 or (it + 1) == total_iters):
                ckpt.save(state, it + 1)
            if (main and eval_fn is not None and cfg.train.eval_period > 0
                    and ((it + 1) % cfg.train.eval_period == 0 or (it + 1) == total_iters)):
                eval_metrics = eval_fn(state, it + 1)
                if eval_metrics:
                    row = {f"val/{k}": float(v) for k, v in eval_metrics.items()}
                    row["iteration"] = it + 1
                    with open(writer.path, "a") as f:
                        f.write(json.dumps(row) + "\n")
                    print(f"eval @ {it + 1}: {eval_metrics}", flush=True)
            if main and cfg.train.vis_period > 0 and (it + 1) % cfg.train.vis_period == 0:
                _dump_batch(batch, cfg.output_dir, it + 1, writer)
            if it + 1 < total_iters:
                t_w = time.perf_counter()
                host_batch = next(loader)
                waits.append(time.perf_counter() - t_w)
                data_wait_s += waits[-1]
    finally:
        loader.close()
    if stats is not None:
        stats.update(timer.summary())
        stats["host_wait"] = [1e3 * w for w in waits]
        if pools is not None:
            stats["pool"] = pools.stats()
    return state


def _dump_batch(batch: dict, output_dir: str, iteration: int, writer: MetricsWriter) -> None:
    """Training-batch tiles (reference TRAIN.VIS, engine.py:371-397)."""
    from ..utils.vis import grid_show
    tiles, titles = [], []
    for i in range(min(4, batch["roi_img"].shape[0])):
        tiles += [batch["roi_img"][i].float().cpu().numpy() * 127 + 127,
                  batch["gt_xyz"][i].float().cpu().numpy(),
                  batch["gt_mask_visib"][i].float().cpu().numpy(),
                  batch["gt_region"][i].float().cpu().numpy()]
        titles += [f"img{i}", "gt_xyz", "mask", "region"]
    canvas = grid_show(tiles, titles, out_path=os.path.join(output_dir, f"vis_{iteration:06d}.png"))
    if writer.tb is not None:
        writer.tb.add_image("train/batch_vis", canvas, iteration)
        writer.tb.flush()
