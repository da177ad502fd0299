"""The training batch as the two BOP'22 recipes build it, against the JAX
package, on the CPU at 160x120.

  * the loader with backgrounds, foreground truncation and depth yields the
    JAX loader's host batches array for array (same seed);
  * ``DevicePool.ensure`` assigns, hits and evicts slot for slot as the
    JAX ``DevicePool`` for the same key sequence, sibling ``protect``
    included, and its buffer holds the same frames;
  * pool mode: for the same seed and the same draws, ``prep_train_batch``
    of a pool batch equals that of the host batch exactly (frames gathered
    from the pools, truncation on the device), with pools small enough that
    every batch evicts while the builder runs ahead: an upload that
    overwrote a slot a queued batch still reads would show here;
  * ``prep_train_batch`` against the JAX trainer's prep (engine/trainer.py:
    188-308, replayed here with the JAX functions and keys, the port fed
    the JAX draws): background replacement and the truncation folded into
    gt_mask_trunc exactly, the augmented crops at 1e-3 on [0, 255] /
    pixel_std, depth ROIs at 1e-6 (the depth augmentation given the JAX
    draws);
  * ``python -m gdrnpp_bop2022_torch.tools.train_gdrn`` trains each
    BOP'22 recipe as configured (colour augmentation at 0.8, backgrounds at
    0.5, and for RGB-D depth augmentation) for 2 steps on the CPU at tiny
    sizes, with the periodic evaluation (depth ROIs for RGB-D);
  * a configured background directory without images raises.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_tpu.datasets import bop_data as jbd
from gdrnpp_bop2022_tpu.datasets.device_pool import DevicePool as JDevicePool
from gdrnpp_bop2022_tpu.datasets.train_loader import GdrnTrainLoader as JLoader
from gdrnpp_bop2022_tpu.engine.batching import build_depth_rois as j_depth_rois
from gdrnpp_bop2022_tpu.engine.batching import build_train_batch_online as j_online
from gdrnpp_bop2022_tpu.ops.color_aug import cosy_aae_color_aug, replace_background
from gdrnpp_bop2022_tpu.ops.crop import roi_crop_resize as j_crop
from gdrnpp_bop2022_tpu.ops.depth_aug import gdrn_depth_aug
from gdrnpp_bop2022_torch.bop.models3d import ModelBank
from gdrnpp_bop2022_torch.config import Config, replace_cfg
from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
from gdrnpp_bop2022_torch.datasets.device_pool import DevicePool, FramePools
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.datasets.train_loader import GdrnTrainLoader
from gdrnpp_bop2022_torch.engine import trainer as tr
from gdrnpp_bop2022_torch.engine.trainer import bg_image_paths, device_bank, \
    make_generators, prep_train_batch
from synth_utils import build_synth_bop
from test_torch_color_aug import jax_cosy_draws
from test_torch_depth_aug import jax_gdrn_depth_draws

W, H = 160, 120
B = 4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("aug")
    syn = build_synth_bop(root / "synth", split="train", n_images=3, seed=3)
    jm = syn["meta"]
    assert (jm.width, jm.height) == (W, H)
    meta = register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=W, height=H,
                                     camera_matrix=jm.camera_matrix))
    bg_dir = root / "bgs"
    os.makedirs(bg_dir)
    rs = np.random.RandomState(0)
    for i in range(6):      # other aspect ratios: the centre crop + resize runs
        cv2.imwrite(str(bg_dir / f"bg{i}.png"), rs.randint(0, 255, (60 + 10 * i, 80, 3),
                                                          np.uint8))
    bank = ModelBank.from_bop_models_dir(str(root / "synth" / "models"), num_points=64,
                                         num_fps=8)
    return {"jrecs": jbd.index_bop_split(syn["split_dir"], jm),
            "trecs": index_bop_split(syn["split_dir"], meta), "meta": meta, "bank": bank,
            "bg_dir": str(bg_dir), "bg_paths": sorted(str(p) for p in bg_dir.glob("*.png")),
            "root": str(root), "det_file": syn["det_file"]}


KW = dict(batch_size=B, im_width=W, im_height=H, seed=7, num_workers=1, truncate_fg=True,
          with_depth=True)


def test_loader_with_bg_trunc_depth_equals_jax(data):
    jl = JLoader(data["jrecs"], bg_paths=data["bg_paths"] + ["/missing.png"], **KW)
    tl = GdrnTrainLoader(data["trecs"], bg_paths=data["bg_paths"] + ["/missing.png"], **KW)
    try:
        for _ in range(3):
            a, b = next(jl), next(tl)
            assert set(a) == set(b) and {"bg_images", "fg_masks", "depths"} <= set(b)
            for k in a:
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
                assert b[k].dtype == a[k].dtype, k
    finally:
        jl.close()
        tl.close()


def test_device_pool_ensure_matches_jax():
    jp, tp = JDevicePool(5, (2, 2)), DevicePool(5, (2, 2))
    fetch = lambda k: np.full((2, 2), hash(k) % 251, np.uint8)      # noqa: E731
    seq = [(["a", "b", "c"], ()), (["b", "d"], ("a",)), (["e", "f", "a"], ("d",)),
           (["g", "b"], ()), (["c", "h", "i", "g"], ("b",)), (["a", "a", "j"], ())]
    for keys, protect in seq:
        want = jp.ensure(keys, fetch, protect=protect)
        got = tp.ensure(keys, fetch, protect=protect)
        np.testing.assert_array_equal(got, want, err_msg=str(keys))
        assert (tp.hits, tp.misses) == (jp.hits, jp.misses)
    np.testing.assert_array_equal(tp.buf.numpy(), np.asarray(jp.buf))
    with pytest.raises(RuntimeError, match="capacity"):
        tp.ensure(list("klmnop"), fetch)


def _cfg(data, **over):
    base = {"model.pose_net.num_classes": 2, "model.pose_net.input_res": 32,
            "model.pose_net.output_res": 8, "model.pose_net.geo_head.num_regions": 8,
            "input.bg_images_dir": data["bg_dir"], "input.truncate_fg": True,
            "input.with_depth": True, "input.depth_aug": True}
    base.update(over)
    return replace_cfg(Config(), base)


def _batches_equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def test_pool_batches_equal_host_batches(data):
    cfg = _cfg(data)
    bank = device_bank(data["bank"], 8, "cpu")
    host = GdrnTrainLoader(data["trecs"], bg_paths=data["bg_paths"], **KW)
    try:
        want = []
        g = make_generators(0, "cpu")
        for _ in range(6):
            want.append(prep_train_batch(next(host), bank, cfg, "cpu", gens=g))
    finally:
        host.close()
    # 4 samples a batch: 4 of the 6 backgrounds and 8 mask slots (a batch's
    # 4 visible + 4 amodal masks at most) make batches evict slots that the
    # batches queued before them read, so the builder (prefetch 2) must
    # wait on their releases
    pools = FramePools(H, W, rgb_frames=4, mask_frames=8, depth_frames=4, bg_frames=4)
    pooled = GdrnTrainLoader(data["trecs"], bg_paths=data["bg_paths"], pools=pools, **KW)
    try:
        g = make_generators(0, "cpu")
        for i, w in enumerate(want):
            hb = next(pooled)
            assert hb["pool_mode"] and hb["pool_bufs"]["seq"] == i
            _batches_equal(prep_train_batch(hb, bank, cfg, "cpu", gens=g), w, f"batch {i}")
    finally:
        pooled.close()
    st = pools.stats()
    assert st["bg_misses"] > 4 and st["mask_misses"] > 8, st


def _jax_prep(hb, bank, cfg, key, fg_masks):
    """The JAX trainer's prep (engine/trainer.py:188-308) for a host batch."""
    pc, inp = cfg.model.pose_net, cfg.input
    k_bg, k_color, k_depth = jax.random.split(key, 3)
    images, gate = replace_background(k_bg, jnp.asarray(hb["images"]).astype(jnp.float32),
                                      jnp.asarray(fg_masks), jnp.asarray(hb["bg_images"]),
                                      prob=inp.change_bg_prob, return_gate=True)
    images = cosy_aae_color_aug(k_color, images, global_prob=inp.color_aug.prob)
    j = lambda k: jnp.asarray(hb[k])                               # noqa: E731
    batch = j_online(images, j("img_idx"), j("centers"), j("scales"), j("bboxes_xyxy"),
                     j("Ks"), j("labels"), j("gt_rots"), j("gt_transes"), j("mask_visib"),
                     j("mask_full"), j("mask_idx"), jnp.asarray(bank.verts),
                     jnp.asarray(bank.faces), jnp.asarray(bank.fps_points[:, :8]),
                     jnp.asarray(bank.extents), input_res=pc.input_res,
                     output_res=pc.output_res, num_regions=8,
                     pixel_mean=tuple(cfg.model.pixel_mean),
                     pixel_std=tuple(cfg.model.pixel_std), xyz_bp=pc.xyz_bp)
    tm = j_crop(jnp.asarray(fg_masks)[..., None], j("centers"), j("scales"), pc.output_res,
                method="nearest")[..., 0]
    tm = jnp.where(gate[:, None, None] > 0, tm, 1.0)
    batch["gt_mask_trunc"] = batch["gt_mask_trunc"] * tm
    depths = gdrn_depth_aug(k_depth, j("depths"), drop_prob=inp.drop_depth_prob,
                            drop_ratio=inp.drop_depth_ratio,
                            noise_prob=inp.add_noise_depth_prob,
                            noise_level=inp.add_noise_depth_level)
    batch["roi_depth"] = j_depth_rois(depths, j("img_idx"), j("centers"), j("scales"),
                                      j("Ks"), input_res=pc.input_res, bp_depth=inp.bp_depth)
    return {k: np.asarray(v) for k, v in batch.items()}, np.asarray(images), np.asarray(gate)


def test_prep_matches_the_jax_trainers_prep(data, monkeypatch):
    cfg = _cfg(data)
    inp = cfg.input
    tl = GdrnTrainLoader(data["trecs"], bg_paths=data["bg_paths"], **KW)
    try:
        hb = next(tl)
    finally:
        tl.close()
    key = jax.random.PRNGKey(11)
    want, want_images, want_gate = _jax_prep(hb, data["bank"], cfg, key, hb["fg_masks"])
    assert 0 < want_gate.sum() < B
    # the port, fed the draws the JAX functions make from the same keys
    k_bg, k_color, k_depth = jax.random.split(key, 3)
    k1, k2 = jax.random.split(k_bg)
    t = lambda d: {k: torch.from_numpy(np.array(v)) for k, v in d.items()}   # noqa: E731
    bg_draws = {"bg_idx": np.asarray(jax.random.randint(k1, (B,), 0, B), np.int64),
                "use": np.asarray(jax.random.bernoulli(k2, inp.change_bg_prob, (B,)),
                                  np.float32)}
    seen = {}
    orig_aug = tr.apply_color_aug

    def spy_aug(images, draws, aug_type):
        out = orig_aug(images, draws, aug_type)
        seen["images"] = out
        return out

    monkeypatch.setattr(tr, "draw_replace_background", lambda *a, **k: t(bg_draws))
    monkeypatch.setattr(tr, "draw_color_aug", lambda g, shape, *a: t(jax_cosy_draws(
        k_color, shape, inp.color_aug.prob)))
    monkeypatch.setattr(tr, "draw_gdrn_depth_aug", lambda g, shape, **k: t(
        jax_gdrn_depth_draws(k_depth, shape, **k)))
    monkeypatch.setattr(tr, "apply_color_aug", spy_aug)
    got = prep_train_batch(hb, device_bank(data["bank"], 8, "cpu"), cfg, "cpu",
                           gens=make_generators(0, "cpu"))
    np.testing.assert_allclose(seen["images"].numpy(), want_images, rtol=0, atol=1e-3)
    for k in ("gt_mask_trunc", "gt_mask_visib", "gt_mask_obj"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert (want["gt_mask_trunc"] < want["gt_mask_visib"] * want["gt_mask_obj"]).any()
    np.testing.assert_allclose(got["roi_img"].numpy(), want["roi_img"], rtol=0,
                               atol=1e-3 / 255.0 * 4)
    np.testing.assert_allclose(got["roi_depth"].numpy(), want["roi_depth"], rtol=0, atol=1e-6)


def test_bg_dir_without_images_raises(tmp_path):
    cfg = replace_cfg(Config(), {"input.bg_images_dir": str(tmp_path)})
    with pytest.raises(FileNotFoundError, match="no .jpg"):
        bg_image_paths(cfg)
    assert bg_image_paths(replace_cfg(Config(), {"input.change_bg_prob": 0.0,
                                                 "input.bg_images_dir": str(tmp_path)})) is None


@pytest.mark.parametrize("recipe", ["ycbv_convnext_base", "ycbv_convnext_base_rgbd"])
def test_recipes_train_two_steps_as_configured(data, recipe, tmp_path):
    from gdrnpp_bop2022_torch.tools import train_gdrn as cli
    from gdrnpp_bop2022_torch.tools.test_gdrn import load_config
    from test_torch_trainer import TINY
    inp = load_config(recipe).input
    assert inp.color_aug.prob == 0.8 and inp.change_bg_prob == 0.5
    assert inp.with_depth == inp.depth_aug == recipe.endswith("rgbd")
    out = tmp_path / "out"
    opts = [f"{k}={v!r}" for k, v in TINY.items()] + [
        f"datasets.root={data['root']!r}", "datasets.train=('synth_train',)",
        "datasets.train2=()", "datasets.test=('synth_train',)",
        f"datasets.det_files_test=({data['det_file']!r},)",
        f"input.bg_images_dir={data['bg_dir']!r}", f"output_dir={str(out)!r}",
        "solver.ims_per_batch=4", "train.num_workers=1", "train.eval_period=2",
        "train.tensorboard=False"]
    state = cli.main(["--config", recipe, "--opts", *opts, "--max-iters", "2", "--device", "cpu"])
    assert state.step == 2
    assert (state.model.depth_backbone is not None) == recipe.endswith("rgbd")
    rows = [json.loads(line) for line in (out / "metrics.json").read_text().splitlines()]
    assert 0.0 <= rows[-1]["val/AR"] <= 1.0
