"""The harness: a cell found by name, the program set up, the window, the metrics, the check.

Everything that belongs to one configuration, traffic mix or metric is read
from its own file by the name ``BENCHMARK.json`` gives it.
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from . import compare
from .reference import gdrn as ref_gdrn
from .reference.serve import reference_poses, uses_depth
from .scene import mesh_bank
from .traffic import make_pool
from .weights import make_weights

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SEED_STREAMS = {"weights": 0, "scene": 1, "axes": 2, "order": 3}
WARMUP_PASSES = 2         # passes over the pool in set-up


def _stream(seed: int, what: str) -> int:
    """A non-negative seed of its own for each thing the run draws."""
    return (seed * 4 + SEED_STREAMS[what]) % 2**63


@dataclass
class Cell:
    name: str
    chips: int
    config: dict           # bench_h100/configs/<config>.json
    mix: dict              # bench_h100/traffic/<traffic>.json
    metrics: list          # [(name, unit, module)] of this cell, end-to-end first
    per_layer: list

    @property
    def arch(self) -> dict:
        return {**self.config["model"], "widths": self.config["widths"]}


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"bench_h100.metrics.{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, manifest: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(manifest).read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in {manifest}: one of {', '.join(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [(m["name"], m["unit"], load_metric(m["name"])) for m in metrics
                if name in m.get("workloads", [name])]
    return Cell(name, w["chips"], config, mix, mine(bench["end_to_end"]),
                mine(bench["per_layer"]))


def _dotted(obj, key: str):
    for part in key.split("."):
        obj = getattr(obj, part)
    return list(obj) if isinstance(obj, tuple) else obj


def program_config(config: dict, opts: dict = None):
    """The program's named configuration with the file's options, held to
    the file's ``model`` block key by key (but for the keys ``opts`` sets:
    a control switches on one of the program's own paths)."""
    from gdrnpp_bop2022_torch.config import replace_cfg
    from gdrnpp_bop2022_torch.configs import GDRN_CONFIGS
    prog = config["program"]
    cfg = replace_cfg(GDRN_CONFIGS[prog["config"]](), {**prog.get("opts", {}), **(opts or {})})
    for key, want in config["model"].items():
        if key in (opts or {}):
            continue
        have = _dotted(cfg, key)
        if have != want:
            raise ValueError(f"{prog['config']}: {key} is {have!r}, the file says {want!r}")
    return cfg


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    model: object
    device_name: str
    cuda: bool = False
    phase: str = "setup"
    setup_s: float = 0.0
    feed: object = None
    trace: object = None       # the device's stretch (trace.Stretch)
    host_trace: object = None  # the stretch that names the idle gaps
    store: dict = field(default_factory=dict)       # what a reader keeps between install and read
    forwards: dict = field(default_factory=dict)    # phase -> forwards
    rows: dict = field(default_factory=dict)        # phase -> ROI rows given to the forward
    window_rois: int = 0
    window_s: float = 0.0

    @property
    def arch(self):
        return self.cell.arch


class Feed:
    """The batches the serving loop takes: the pool's batches in turn."""

    def __init__(self, run: Run, pool: list, seconds: float, trace_batches: int):
        self.run, self.pool, self.seconds, self.trace_batches = run, pool, seconds, trace_batches
        self.order, self.lat = [], []
        self.t_start = self.t_end = None

    def _next(self):
        b = len(self.order) % len(self.pool)
        self.order.append(b)
        return self.pool[b]

    def __iter__(self):
        run = self.run
        run.phase = "warm"
        yield self._next()
        now = self.t_start = time.perf_counter()
        run.phase = "window"
        while now - self.t_start < self.seconds:
            batch = self._next()
            taken = time.perf_counter()
            yield batch
            now = time.perf_counter()
            self.lat.append(now - taken)
        self.t_end = now
        for phase, stretch in (("trace", run.trace), ("host_trace", run.host_trace)):
            if not self.trace_batches:
                break
            run.phase = phase
            stretch.start()
            for _ in range(self.trace_batches):
                yield self._next()
            stretch.stop()
            stretch.batches = self.trace_batches
        run.phase = "after"

    def window_batches(self):
        return self.order[1:1 + len(self.lat)]


class Session:
    """The program's model for a cell's configuration on ``device``."""

    def __init__(self, cell: Cell, device, opts: dict = None):
        from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
        self.cell, self.device = cell, torch.device(device)
        self.cfg = program_config(cell.config, opts)
        self.shapes = ref_gdrn.param_shapes(cell.arch)
        with torch.device(self.device):
            self.model = build_gdrn(self.cfg, device=self.device)

    def _serve_kwargs(self, bank):
        cfg, pc = self.cfg, self.cfg.model.pose_net
        post = "depth_refine" if cfg.val.use_depth_refine else "direct"
        if cfg.val.use_pnp and not cfg.val.use_depth_refine:
            raise ValueError("the harness serves post modes direct and depth_refine")
        return dict(input_res=pc.input_res, output_res=pc.output_res,
                    pixel_mean=cfg.model.pixel_mean, pixel_std=cfg.model.pixel_std,
                    post_mode=post, model_bank=bank,
                    depth_refine_iters=cfg.val.depth_refine_iters,
                    depth_refine_threshold=cfg.val.depth_refine_threshold,
                    mask_loss_type=pc.loss.mask_loss_type, with_depth_input=cfg.input.with_depth,
                    bp_depth=cfg.input.bp_depth, coord_2d_type=pc.pnp_net.coord_2d_type)

    def inputs(self, seed: int):
        """The seed's class sizes, meshes and pool of host batches."""
        sc = self.cell.config["scene"]
        rng = np.random.default_rng(_stream(seed, "axes"))
        axes = rng.uniform(*sc["axes_m"], (self.cfg.model.pose_net.num_classes, 3))
        verts, faces = mesh_bank(axes, *sc["mesh_lat_lon"])
        gen = torch.Generator(device=self.device).manual_seed(_stream(seed, "scene"))
        pool = make_pool(self.cell.mix, sc, axes, _stream(seed, "order"), gen, self.device,
                         uses_depth(self.cell.arch))
        bank = type("Bank", (), {"verts": verts, "faces": faces})
        return 2 * axes.astype(np.float32), bank, pool

    def weights(self, seed: int) -> dict:
        return make_weights(self.shapes, _stream(seed, "weights"), self.device,
                            self.cell.config.get("init", ()))

    def serve(self, seed: int, seconds: float, trace: bool, t_process: float = None) -> dict:
        """One run: the window, the metrics, then (the model freed) the check."""
        from gdrnpp_bop2022_torch.engine.inference import run_gdrn_inference
        from .trace import Stretch
        cell, dev = self.cell, self.device
        self.model.load_state_dict(self.weights(seed), strict=True)
        extents, bank, pool = self.inputs(seed)
        kw = self._serve_kwargs(bank)
        # build the kernels, choose cuDNN's algorithms, fill the allocator, bring the clocks up
        run_gdrn_inference(self.model, pool * WARMUP_PASSES, extents, **kw)
        cuda = dev.type == "cuda"
        run = Run(cell, self.model, torch.cuda.get_device_name(dev) if cuda else "cpu", cuda)
        hooks = []
        if trace:
            run.trace, run.host_trace = Stretch(cuda), Stretch(cuda, host=True)
            hooks.append(self.model.register_forward_pre_hook(_count_rows(run), with_kwargs=True))
            for _, _, mod in cell.per_layer:
                if hasattr(mod, "install"):
                    hooks += mod.install(run) or []
        feed = run.feed = Feed(run, pool, seconds, cell.mix["trace_batches"] if trace else 0)
        results = run_gdrn_inference(self.model, feed, extents, **kw)
        run.setup_s = feed.t_start - t_process if t_process is not None else 0.0
        for h in hooks:
            h.remove()
        run.window_s = feed.t_end - feed.t_start
        run.window_rois = int(sum(pool[b]["valid"].sum() for b in feed.window_batches()))
        window = {"batches": len(feed.lat), "rois": run.window_rois, "seconds": run.window_s,
                  "batch_p50_ms": float(np.median(feed.lat) * 1e3) if feed.lat else None,
                  "pool_valid": [int(b["valid"].sum()) for b in pool]}
        if trace:
            for name, st in (("trace", run.trace), ("host_trace", run.host_trace)):
                window[f"{name}_batch_ms"] = st.window_s / st.batches * 1e3
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        metrics = {}
        for name, unit, mod in (cell.per_layer if trace else cell.metrics):
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        device = {"platform": "gpu" if cuda else dev.type, "kind": run.device_name,
                  "count": 1, "memory_peak_bytes": int(peak)}
        out = {"correct": None, "attempted": run.window_rois, "failed": 0, "metrics": metrics,
               "device": device}
        if trace:
            device.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
            out["breakdown"] = {"device_ops": run.trace.device_ops(),
                                "idle_gaps": run.host_trace.idle_gaps()}
            run.trace = run.host_trace = None
        run.model = feed.run = None
        del self.model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rows = self.check(seed, pool, extents, bank, feed, results)
        read = compare.readings(rows, cell.config["correct"].get("shares"))
        ok, compared = compare.judge(read, cell.config["correct"]["limits"])
        out.update(correct=ok, failed=int(read["rows_missing"] + read["rows_misplaced"]),
                   _readings=read, _window=window, _rows=rows)
        out["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
        out["_compared"] = compared
        return out

    def check(self, seed, pool, extents, bank, feed, results) -> dict:
        """The reference's pose for every pool ROI, then every row against it."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            P = self.weights(seed)
            ref = [reference_poses(P, self.cell.arch, b, extents, bank.verts, bank.faces,
                                   self.device, int(b["valid"].sum()),
                                   self.cell.config["correct"]["block"]) for b in pool]
            del P
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        return compare.per_row(results, feed.order, pool, ref, extents)


def _count_rows(run: Run):
    def hook(_module, args, kwargs):
        rows = kwargs["roi_img"].shape[0] if "roi_img" in kwargs else args[0].shape[0]
        run.forwards[run.phase] = run.forwards.get(run.phase, 0) + 1
        run.rows[run.phase] = run.rows.get(run.phase, 0) + rows
    return hook


