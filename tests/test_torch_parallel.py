"""Data parallelism (``gdrnpp_bop2022_torch/parallel``) in two gloo processes
on the CPU, each against a world of one on the same global batch.

* ``gather_results`` concatenates the ranks' rows in rank order.
* One tiny GDRN train step (convnext_tiny, fp32, SGD with clipping at 1.0,
  RW_BCE visible mask, masked xyz L1 and region CE) at world 2, each rank on
  half of a batch of 4 whose visible and truncated masks are dense on one
  half and sparse on the other (so the masked losses' denominators differ
  between the ranks): the synchronised gradients within 1e-4 of each
  tensor's largest (measured 1.0e-5: the sums over the pixels and the
  batch are taken in another order), the parameters after the step within 1e-6 of each
  tensor's largest, the ranks' averaged metrics within 1e-5 relative of
  world 1's, and both ranks' parameters and EMA bit-equal.
* One YOLOX step (yolox_s widths, BN in training, 64^2, SGD) at world 2 on a
  batch of 4 whose images carry 40 and 2 GT boxes (``num_fg`` differs per
  rank): the BN running statistics within 1e-4 of each tensor's largest
  (global-batch statistics; measured 1.0e-5 on a mean near 0), the
  gradients within 1e-3 of each tensor's largest (a BN backward through ~70 layers amplifies summation order, as
  the CPU alone shows at 1e-4-1e-3), and so the step's parameter updates
  within 1e-3 of each tensor's largest update, plus two fp32 ulps at 1.0
  (an update is the difference of two parameters of order 1).
* (``test_torch_parallel_eval.py``: ``test_gdrn`` and ``train_gdrn`` over
  two processes; ``test_torch_parallel_yolox.py``: ``train_yolox``.)
* ``make_mesh`` raises on a size other than the world's and on an axis
  other than "data"; ``shard_batch`` on a batch that does not split.
"""

import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gdrnpp_bop2022_torch.parallel import (gather_results, initialize_distributed,
                                           make_mesh, shard_batch, shutdown)

TINY = {"model.pose_net.num_classes": 2, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32",
        "model.pose_net.loss.mask_loss_type": "RW_BCE", "solver.optimizer": "sgd",
        "solver.clip_grad_norm": 1.0, "model.pose_net.loss.pm_loss_sym": False}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(fn, *args):
    mp.start_processes(fn, args=(_free_port(), *args), nprocs=2, join=True,
                       start_method="spawn")


def _join(rank, port):
    torch.set_num_threads(2)
    return initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo")


# -- GDRN -------------------------------------------------------------------

def _gdrn_batch():
    from gdrnpp_bop2022_torch.utils.fake_data import fake_gdrn_batch
    b = fake_gdrn_batch(4, 64, 16, num_classes=2, num_regions=8, num_points=32, seed=3)
    rs = np.random.RandomState(9)
    for k in ("gt_mask_visib", "gt_mask_trunc"):
        b[k][2:] = (rs.uniform(0, 1, b[k][2:].shape) > 0.9).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    for k in ("roi_labels", "gt_region"):
        t[k] = t[k].long()
    return t


def _gdrn_step(world=1):
    from gdrnpp_bop2022_torch.config import Config, replace_cfg
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.train_step import make_train_step
    from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
    from gdrnpp_bop2022_torch.parallel import broadcast_module, mean_over_ranks
    from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
    from gdrnpp_bop2022_torch.utils.weights import seeded_state_dict
    cfg = replace_cfg(Config(), TINY)
    model = build_gdrn(cfg, device="cpu", train=True)
    model.load_state_dict(seeded_state_dict(model, 1))
    broadcast_module(model)
    state = create_train_state(model, build_optimizer(cfg, lambda step: 0.05, model),
                               ema_decay=0.9, ema_warmup=1.0)
    batch = shard_batch(_gdrn_batch(), make_mesh())
    assert batch["roi_img"].shape[0] == 4 // world
    metrics = make_train_step(cfg)(state, batch)
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone() for n, p in model.named_parameters()},
            "ema": [e.clone() for e in state.ema],
            "metrics": {k: float(v) for k, v in mean_over_ranks(metrics).items()},
            "local_total": float(metrics["total_loss"])}


def _gdrn_worker(rank, port, out):
    _join(rank, port)
    rows = gather_results([{"rank": rank, "i": i} for i in range(rank + 2)])
    torch.save({"rows": rows, **_gdrn_step(2)}, os.path.join(out, f"gdrn{rank}.pt"))
    shutdown()


def _close(got, want, tol, what, floor=0.0):
    for n in want:
        scale = max(float(want[n].abs().max()), 1e-12)
        err = float((got[n] - want[n]).abs().max())
        assert err <= tol * scale + floor, (what, n, err / scale)


def test_gdrn_step_world2_equals_world1(tmp_path):
    torch.set_num_threads(2)
    want = _gdrn_step()
    _spawn(_gdrn_worker, str(tmp_path))
    r0, r1 = (torch.load(tmp_path / f"gdrn{r}.pt") for r in range(2))
    rows = [{"rank": 0, "i": 0}, {"rank": 0, "i": 1},
            {"rank": 1, "i": 0}, {"rank": 1, "i": 1}, {"rank": 1, "i": 2}]
    assert r0["rows"] == r1["rows"] == rows             # gather_results: rank order
    assert r0["local_total"] != r1["local_total"]       # the halves differ
    _close(r0["grads"], want["grads"], 1e-4, "grads")
    _close(r0["params"], want["params"], 1e-6, "params")
    for k, v in want["metrics"].items():
        assert abs(r0["metrics"][k] - v) <= 1e-5 * max(abs(v), 1e-6), k
    for n in r0["params"]:
        assert torch.equal(r0["params"][n], r1["params"][n]), n
    assert all(torch.equal(a, b) for a, b in zip(r0["ema"], r1["ema"]))


# -- YOLOX BN ---------------------------------------------------------------

def _yolox_batch():
    rs = np.random.RandomState(5)
    B, S, G = 4, 64, 40
    boxes = np.zeros((B, G, 4), np.float32)
    boxes[..., :2] = rs.uniform(0.1 * S, 0.9 * S, (B, G, 2))
    boxes[..., 2:] = rs.uniform(0.05 * S, 0.4 * S, (B, G, 2))
    n = np.array([40, 40, 2, 2])
    return {"images": torch.from_numpy(rs.uniform(0, 255, (B, S, S, 3)).astype(np.float32)),
            "gt_boxes": torch.from_numpy(boxes),
            "gt_labels": torch.from_numpy(rs.randint(0, 3, (B, G)).astype(np.int32)),
            "gt_valid": torch.from_numpy(np.arange(G)[None] < n[:, None])}


def _yolox_step():
    from gdrnpp_bop2022_torch.engine.train_state import create_train_state
    from gdrnpp_bop2022_torch.engine.yolox_trainer import (build_yolox_optimizer,
                                                           init_yolox_weights,
                                                           make_yolox_train_step)
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    from gdrnpp_bop2022_torch.parallel import mean_over_ranks
    model = build_yolox(3, "yolox_s", norm="BN", device="cpu", dtype=torch.float32)
    init_yolox_weights(model, 0)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(model, build_yolox_optimizer(model, lambda s: 0.01, "sgd"),
                               ema_decay=0.9)
    batch = shard_batch(_yolox_batch(), make_mesh())
    metrics = make_yolox_train_step(model.strides)(state, batch)
    bufs = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    return {"grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "updates": {n: p.detach() - p0[n] for n, p in model.named_parameters()},
            "stats": bufs, "metrics": {k: float(v) for k, v in mean_over_ranks(metrics).items()},
            "local_fg": float(metrics["num_fg_per_img"])}


def _yolox_worker(rank, port, out):
    _join(rank, port)
    torch.save(_yolox_step(), os.path.join(out, f"yolox{rank}.pt"))
    shutdown()


def test_yolox_bn_step_world2_equals_world1(tmp_path):
    torch.set_num_threads(2)
    want = _yolox_step()
    _spawn(_yolox_worker, str(tmp_path))
    r0, r1 = (torch.load(tmp_path / f"yolox{r}.pt") for r in range(2))
    assert r0["local_fg"] != r1["local_fg"]
    _close(r0["stats"], want["stats"], 1e-4, "stats")
    _close(r1["stats"], want["stats"], 1e-4, "stats")
    _close(r0["grads"], want["grads"], 1e-3, "grads")
    # an update of a parameter near 1 carries its fp32 ulp (1.2e-7)
    _close(r0["updates"], want["updates"], 1e-3, "updates", floor=2.4e-7)
    for k in ("loss_iou", "loss_obj", "loss_cls", "total_loss"):
        v = want["metrics"][k]
        assert abs(r0["metrics"][k] - v) <= 1e-5 * abs(v), k


# -- mesh -------------------------------------------------------------------

def test_make_mesh_and_shard_batch_raise():
    assert make_mesh().size == 1 and make_mesh((1,)).index == 0
    with pytest.raises(ValueError, match="world has 1"):
        make_mesh((2,))
    with pytest.raises(NotImplementedError, match="data"):
        make_mesh((-1,), ("model",))
    with pytest.raises(NotImplementedError):
        make_mesh((-1, 1), ("data", "model"))
    from gdrnpp_bop2022_torch.parallel.mesh import Mesh
    b = {"x": torch.zeros(6, 2), "k": torch.zeros(3)}
    assert shard_batch(b, Mesh(size=1, index=0)) is b
    half = shard_batch(b, Mesh(size=2, index=1))
    assert half["x"].shape == (3, 2) and half["k"].shape == (3,)
    with pytest.raises(ValueError, match="split"):
        shard_batch({"x": torch.zeros(5)}, Mesh(size=2, index=0))
