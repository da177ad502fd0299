"""YOLOX training on the CPU through its entry points (no JAX here: the
parts are held to the JAX package in ``tests/test_torch_yolox_train.py``).

  * ``train_yolox`` for 3 iterations on a synthetic split with a checkpoint,
    a resume to 4, the in-train eval with precise BN and ``best_val.json``;
  * ``python -m gdrnpp_bop2022_torch.tools.train_yolox --config ycbv --device
    cpu`` with tiny flags for 2 iterations on a synthetic ycbv split, then
    ``test_yolox --config ycbv --ckpt`` serving its EMA weights as the EMA
    state dict loaded by hand does.
"""

import json
import os

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.engine import yolox_trainer as ttrainer
from synth_utils import build_synth_bop


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --- the trainer, the CLI and test_yolox --ckpt ------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A BOP root with a synthetic ycbv/train_pbr (4 images) and ycbv/test
    (2 images), two cubes an image (YCB-V's objects 1 and 2)."""
    root = tmp_path_factory.mktemp("yolox_train")
    syn = build_synth_bop(root / "ycbv", split="train_pbr", n_images=4, seed=5)
    build_synth_bop(root / "ycbv", split="test", n_images=2, seed=6)
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    from gdrnpp_bop2022_torch.datasets.yolox_loader import det_records_from_instances
    recs = det_records_from_instances(index_bop_split(syn["split_dir"], get_meta("ycbv")))
    assert len(recs) == 4 and all(len(r.labels) == 2 for r in recs)
    return root, recs


def test_train_yolox_checkpoint_resume_eval(synth, tmp_path):
    from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
    _, recs = synth
    evals = []

    def eval_fn(weights, it):
        evals.append((it, {k: v.clone() for k, v in weights.items()}))
        return {"AP50": 0.1 * it}

    kw = dict(num_classes=2, output_dir=str(tmp_path), size="yolox_s", input_size=64,
              batch_size=2, base_lr=0.01 / 64, log_period=1, ckpt_period=3, norm="BN",
              eval_fn=eval_fn, eval_period=3, precise_bn_iters=2, multiscale_range=1,
              multiscale_period=2, no_aug_iters=1, device="cpu")
    state = ttrainer.train_yolox(recs, total_iters=3, **kw)
    assert state.step == 3
    rows = [json.loads(line) for line in open(tmp_path / "metrics_yolox.json")]
    train_rows = [r for r in rows if "total_loss" in r]
    assert [r["iteration"] for r in train_rows] == [1, 2, 3]
    assert all(np.isfinite(r["total_loss"]) for r in train_rows)
    assert "loss_l1" in train_rows[-1] and "loss_l1" not in train_rows[0]   # the no-aug switch
    assert train_rows[-1]["img_size"] == 64
    assert [r["iteration"] for r in rows if "val/AP50" in r] == [3]
    # the eval saw the EMA parameters with the precise-BN statistics
    (_, w), = evals
    ema = state.ema_state_dict()
    assert all(torch.equal(w[k], ema[k]) for k in ema)
    sd = state.model.state_dict()
    bn_key = "backbone.backbone.stem.conv.bn.running_var"
    assert torch.equal(w[bn_key], sd[bn_key])
    assert json.load(open(tmp_path / "best_val.json"))["iteration"] == 3

    # the best checkpoint was saved after precise BN (the periodic one before it)
    best = CheckpointManager(str(tmp_path / "ckpt_yolox_best"))
    saved = torch.load(best.path(3), weights_only=False)
    assert torch.equal(saved["model"][bn_key], sd[bn_key])
    assert all(torch.equal(saved["ema"][k], ema[k]) for k in ema)
    # resume to 4 from ckpt_yolox
    state2 = ttrainer.train_yolox(recs, total_iters=4, **kw)
    assert state2.step == 4
    assert [r["iteration"] for r in map(json.loads, open(tmp_path / "metrics_yolox.json"))
            if "total_loss" in r][-1] == 4


def test_cli_train_then_test_yolox_ckpt(synth, tmp_path):
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    from gdrnpp_bop2022_torch.models.yolox.yolox import make_inference
    from gdrnpp_bop2022_torch.tools import test_yolox, train_yolox
    root, _ = synth
    out = tmp_path / "run"
    state = train_yolox.main([
        "--config", "ycbv", "--root", str(root), "--size", "yolox_s", "--input-size", "64",
        "--batch-size", "2", "--total-iters", "2", "--no-aug-iters", "1", "--out", str(out),
        "--opts", "random_size=(1,3)", "warmup_epochs=1", "--device", "cpu"])
    assert state.step == 2
    rows = [json.loads(r) for r in open(out / "metrics_yolox.json")]
    assert [r["iteration"] for r in rows] == [1]         # the first, then every 20
    ckpt = out / "ckpt_yolox"
    assert os.listdir(ckpt) == ["ckpt_00000002.pth"]

    handoff, m, _ = test_yolox.main([
        "--config", "ycbv", "--root", str(root), "--size", "yolox_s", "--input-size", "64",
        "--ckpt", str(ckpt), "--no-tta", "--conf-thr", "0.0", "--batch-size", "2",
        "--out", str(tmp_path / "det"), "--device", "cpu"])
    # the same detections as the EMA state dict loaded by hand
    payload = torch.load(ckpt / "ckpt_00000002.pth", weights_only=False)
    model = build_yolox(21, "yolox_s", device="cpu", dtype=torch.float32)
    sd = dict(payload["model"])
    sd.update(payload["ema"])
    assert not torch.equal(sd["head.cls_preds.0.weight"], payload["model"]["head.cls_preds.0.weight"])
    model.load_state_dict(sd, strict=True)
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split, load_image
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    from gdrnpp_bop2022_torch.datasets.yolox_loader import letterbox
    paths = sorted({r.scene_im_id: r.rgb_path for r in index_bop_split(
        str(root / "ycbv" / "test"), get_meta("ycbv"))}.items())
    canv = [letterbox(load_image(p), 64) for _, p in paths]
    det = make_inference(model, conf_thr=0.0)(
        torch.from_numpy(np.stack([c for c, _ in canv])).float())
    for j, (key, _) in enumerate(paths):
        keep = (det["valid"][j] & (det["scores"][j] > 0)).numpy()
        want = sorted(round(float(s), 5) for s in det["scores"][j].numpy()[keep])
        got = sorted(round(r["score"], 5) for r in handoff[key])
        assert got == want and len(got) > 0, key
