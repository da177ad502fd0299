"""The port's training loop, loader, checkpoints and CLI on the CPU.

  * ``GdrnTrainLoader`` yields the JAX package's host batches array for
    array from the same seed (random and repeat-factor sampling, a second
    record list at a ratio, the decoded-file cache);
  * ``train_gdrn`` on the synthetic split of
    ``tests/synth_utils.py::build_synth_bop`` with the tiny config of
    ``tests/test_train_overfit.py`` (convnext_tiny at 64 -> 16, Adam at
    1e-3, batch 8, no colour augmentation) for 20 steps (the JAX test takes
    80; 20 fit this file's time): the loss falls by that test's criterion
    (last logged < 0.85 x first, lowest < 0.80 x first; logged at steps 1,
    10 and 20);
  * the checkpoint restores params, EMA and optimizer state bit for bit;
  * the trainer refuses offline XYZ (as the JAX one does) and nothing
    else of the two recipes' options;
  * ``python -m gdrnpp_bop2022_torch.tools.train_gdrn`` runs 2 steps with
    ``--device cpu``, with the periodic evaluation and the batch dump, and
    ``--eval-only`` scores its checkpoint; a pretrained backbone loads.
"""

import json
import os

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.datasets import bop_data as jbd
from gdrnpp_bop2022_tpu.datasets.train_loader import GdrnTrainLoader as JLoader
from gdrnpp_bop2022_torch.bop.models3d import ModelBank
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
from gdrnpp_bop2022_torch.engine.train_state import create_train_state
from gdrnpp_bop2022_torch.engine.trainer import check_config, train_gdrn
from gdrnpp_bop2022_torch.models.gdrn import build_gdrn
from gdrnpp_bop2022_torch.solver.ranger import build_optimizer
from gdrnpp_bop2022_torch.tools import train_gdrn as cli
from synth_utils import build_synth_bop

TINY = {"model.pose_net.num_classes": 2, "model.pose_net.input_res": 64,
        "model.pose_net.output_res": 16, "model.pose_net.backbone.name": "convnext_tiny",
        "model.pose_net.geo_head.feat_dim": 32, "model.pose_net.geo_head.num_gn_groups": 8,
        "model.pose_net.geo_head.num_regions": 8, "model.pose_net.pnp_net.featdim": 32,
        "model.pose_net.pnp_net.num_gn_groups": 8, "model.compute_dtype": "float32"}
N_ITERS = 20


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads while this file runs: the suite runs six
    workers on eight cores, and torch's default of one thread per core in
    each of them oversubscribes the CPU (one run took 30x longer)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("bop_train")
    syn = build_synth_bop(root / "synth", split="train", n_images=4, seed=3)
    jm = syn["meta"]
    meta = register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                                     height=jm.height, camera_matrix=jm.camera_matrix))
    bank = ModelBank.from_bop_models_dir(str(root / "synth" / "models"), num_points=128,
                                         num_fps=8)
    return root, syn, meta, bank


def _train_cfg(output_dir):
    """tests/test_train_overfit.py::_tiny_train_cfg, for the port."""
    return replace_cfg(Config(), dict(TINY, **{
        "output_dir": str(output_dir), "model.ema_warmup_updates": 10,
        "input.color_aug": {"prob": 0.0}, "solver.optimizer": "adam",
        "solver.ims_per_batch": 8, "solver.base_lr": 1e-3, "solver.total_epochs": 1,
        "solver.warmup_iters": 5, "solver.checkpoint_period_epochs": 1000,
        "train.log_period": 10, "datasets.train": ("synth_train",)}))


@pytest.mark.parametrize("sampler,ratio2", [("random", 0.0), ("repeat_factor", 0.3)])
def test_loader_batches_equal_jax(synth, sampler, ratio2):
    _, syn, meta, _ = synth
    jrecs = jbd.index_bop_split(syn["split_dir"], syn["meta"])
    trecs = index_bop_split(syn["split_dir"], meta)
    kw = dict(batch_size=5, im_width=meta.width, im_height=meta.height, seed=11,
              sampler=sampler, repeat_thresh=0.9, num_workers=2, cache_gb=0.01,
              ratio2=ratio2, dzi_type="uniform")
    jl = JLoader(jrecs, records2=jrecs[:3] if ratio2 else None, **kw)
    tl = GdrnTrainLoader(trecs, records2=trecs[:3] if ratio2 else None, **kw)
    try:
        for _ in range(3):
            a, b = next(jl), next(tl)
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert b[k].dtype == a[k].dtype, k
        assert tl.cache_hits > 0
    finally:
        jl.close()
        tl.close()


def test_train_loss_falls_and_checkpoint_restores(synth, tmp_path):
    root, syn, meta, bank = synth
    cfg = _train_cfg(tmp_path / "out")
    records = index_bop_split(syn["split_dir"], meta)
    assert len(records) == 8
    state = train_gdrn(cfg, records, bank, max_iters=N_ITERS, resume=False, meta=meta,
                       device="cpu")
    assert state.step == N_ITERS
    rows = [json.loads(line) for line in open(os.path.join(cfg.output_dir, "metrics.json"))]
    first, last = rows[0]["total_loss"], rows[-1]["total_loss"]
    assert np.isfinite(first) and np.isfinite(last)
    assert last < first * 0.85, (first, last)
    assert min(r["total_loss"] for r in rows) < first * 0.80
    assert {"loss_coor_x", "loss_region", "loss_PM_R", "error_R_deg", "lr",
            "data_wait_ms"} <= set(rows[-1])
    assert os.listdir(os.path.join(cfg.output_dir, "tb"))

    # the checkpoint of the last step restores params, EMA and optimizer state
    mgr = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
    assert mgr.latest_step() == N_ITERS
    model = build_gdrn(cfg, device="cpu", train=True)
    fresh = create_train_state(model, build_optimizer(cfg, 1e-3, model))
    assert mgr.restore_latest(fresh) is fresh and fresh.step == N_ITERS
    for (n, p), (_, q) in zip(state.model.named_parameters(), fresh.model.named_parameters()):
        assert torch.equal(p, q), n
    for e, f in zip(state.ema, fresh.ema):
        assert torch.equal(e, f)
    assert not all(torch.equal(e, p) for e, p in zip(fresh.ema, fresh.model.parameters()))
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        for k, v in state.optimizer.state[p].items():
            assert torch.equal(v, fresh.optimizer.state[q][k]), k
    assert fresh.optimizer.param_groups[0]["count"] == N_ITERS
    # max_to_keep
    mgr2 = CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    for s in (1, 2, 3):
        mgr2.save(fresh, s)
    assert sorted(os.listdir(mgr2.directory)) == ["ckpt_00000002.pth", "ckpt_00000003.pth"]


@pytest.mark.parametrize("over", [
    {"input.color_aug": {"prob": 0.8}}, {"input.truncate_fg": True},
    {"input.with_depth": True}, {"train.device_pool_frames": 16},
    {"model.pose_net.pnp_net.drop_prob": 0.1}, {"model.pose_net.loss.use_mtl": True},
    {"model.pose_net.xyz_online": False},
    {"input.bg_images_dir": "/bg", "input.color_aug": {"prob": 0.0}}])
def test_slice_3b_configs_raise(over):
    """Colour augmentation, backgrounds and truncation, depth, pools, DropBlock
    and use_mtl train; offline XYZ alone raises, as in
    the JAX package's trainer (engine/trainer.py:98-108)."""
    base = {"input.color_aug": {"prob": 0.0}, "input.bg_images_dir": ""}
    cfg = replace_cfg(Config(), dict(base, **over))
    if "model.pose_net.xyz_online" in over:
        with pytest.raises(NotImplementedError, match="xyz_online=False"):
            check_config(cfg)
    else:
        check_config(cfg)
    check_config(replace_cfg(Config(), base))


def test_cli_trains_two_steps_on_the_cpu(synth, tmp_path, capsys):
    """Two steps with the periodic evaluation (EMA weights, mssd / mspd on
    the split's detections) and the batch dump at step 2, then --eval-only
    on the checkpoint."""
    root, syn, _, _ = synth
    out = tmp_path / "cli"
    opts = [f"{k}={v!r}" for k, v in TINY.items()] + [
        f"datasets.root={str(root)!r}", "datasets.train=('synth_train',)",
        "datasets.test=('synth_train',)", f"datasets.det_files_test=({syn['det_file']!r},)",
        f"output_dir={str(out)!r}", "input.color_aug.prob=0.0", "solver.ims_per_batch=4",
        "train.log_period=1", "train.num_workers=1", "train.eval_period=2",
        "train.vis_period=2", "val.error_types='mssd,mspd'", "model.load_dets_test=False"]
    state = cli.main(["--config", "default", "--opts", *opts, "--max-iters", "2",
                      "--device", "cpu"])
    assert state.step == 2 and not next(state.model.parameters()).is_cuda
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    assert [r["iteration"] for r in rows] == [1, 2, 2]
    assert 0.0 <= rows[-1]["val/AR"] <= 1.0 and "val/AR_mssd" in rows[-1]
    assert (out / "ckpt" / "ckpt_00000002.pth").exists() and (out / "vis_000002.png").exists()
    assert "iter 2/2" in capsys.readouterr().out
    results, scores = cli.main(["--config", "default", "--opts", *opts, "--eval-only",
                                "--device", "cpu"])
    assert len(results) == 8 and 0.0 <= scores["AR"] <= 1.0


def test_pretrained_backbone_loads(tmp_path):
    from gdrnpp_bop2022_torch.engine.trainer import _load_pretrained_backbone
    cfg = replace_cfg(Config(), TINY)
    src = build_gdrn(cfg, device="cpu")
    torch.save({"model": src.state_dict()}, tmp_path / "full.pth")   # "backbone." names
    torch.save(src.backbone.state_dict(), tmp_path / "bb.pth")        # timm names
    for name in ("full.pth", "bb.pth"):
        dst = build_gdrn(cfg, device="cpu")
        _load_pretrained_backbone(dst, str(tmp_path / name))
        for (n, a), (_, b) in zip(src.backbone.state_dict().items(),
                                  dst.backbone.state_dict().items()):
            assert torch.equal(a, b), n
    torch.save({"head.fc.weight": torch.zeros(1)}, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="lacks"):
        _load_pretrained_backbone(build_gdrn(cfg, device="cpu"), str(tmp_path / "bad.pth"))
