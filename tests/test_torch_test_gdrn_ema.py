"""The port's ``tools.test_gdrn --weights`` serves a training checkpoint's
EMA weights, as the JAX tools/test_gdrn.py serves ``ema_params`` with
``model.ema_enabled`` (the default).

Two tiny training steps on the CPU (Adam at 1e-3, an EMA warmup of one
update so the EMA stays apart from the weights) save a checkpoint through
``CheckpointManager``; ``test_gdrn.main --weights ckpt_*.pth`` then serves
the synthetic test split on GT boxes. Its rows equal, bit for bit, those
served from a state dict of ``payload["ema"]``, and differ from those of
``payload["model"]``; with ``model.ema_enabled=False`` it serves
``payload["model"]``.
"""

import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.bop.models3d import ModelBank
from gdrnpp_bop2022_torch.config import Config, parse_opts, replace_cfg
from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta, register_meta
from gdrnpp_bop2022_torch.engine.checkpoint import CheckpointManager
from gdrnpp_bop2022_torch.engine.trainer import train_gdrn
from gdrnpp_bop2022_torch.tools import test_gdrn
from synth_utils import build_synth_bop
from test_torch_tools import TINY


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _serve(opts, weights):
    results, _ = test_gdrn.main(["--opts", *opts, "val.save_results_only=True",
                                 "--weights", str(weights), "--device", "cpu"])
    return np.stack([np.concatenate([r["R"].ravel(), r["t"].ravel()]) for r in results])


def test_test_gdrn_serves_the_ema_of_a_checkpoint(tmp_path):
    root = tmp_path / "bop"
    syn = build_synth_bop(root / "synth", split="train", n_images=2, seed=3)
    build_synth_bop(root / "synth", split="test", n_images=2, seed=4)
    jm = syn["meta"]
    meta = register_meta(DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                                     height=jm.height, camera_matrix=jm.camera_matrix))
    out = tmp_path / "out"
    cfg = replace_cfg(Config(), parse_opts(TINY + [
        f"output_dir={str(out)!r}", "input.color_aug.prob=0.0", "solver.optimizer='adam'",
        "solver.base_lr=1e-3", "solver.warmup_iters=0", "solver.ims_per_batch=4",
        "model.ema_warmup_updates=1", "train.num_workers=1", "train.tensorboard=False",
        "datasets.train=('synth_train',)"]))
    bank = ModelBank.from_bop_models_dir(str(root / "synth" / "models"), num_fps=8)
    records = index_bop_split(syn["split_dir"], meta)
    train_gdrn(cfg, records, bank, max_iters=2, resume=False, meta=meta, device="cpu")
    mgr = CheckpointManager(str(out / "ckpt"))
    ckpt = mgr.path(mgr.latest_step())
    payload = torch.load(ckpt, map_location="cpu", weights_only=False)
    assert any(not torch.equal(payload["ema"][k], v) for k, v in payload["model"].items())
    torch.save(payload["ema"], tmp_path / "ema.pth")
    torch.save({"model": payload["model"]}, tmp_path / "model.pth")

    opts = TINY + [f"datasets.root={str(root)!r}", "datasets.test=('synth_test',)",
                   "model.load_dets_test=False", f"output_dir={str(tmp_path / 'serve')!r}"]
    served = _serve(opts, ckpt)
    np.testing.assert_array_equal(served, _serve(opts, tmp_path / "ema.pth"))
    raw = _serve(opts, tmp_path / "model.pth")
    assert np.abs(served - raw).max() > 1e-6
    np.testing.assert_array_equal(_serve(opts + ["model.ema_enabled=False"], ckpt), raw)
