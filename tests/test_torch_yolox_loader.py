"""Port parity: the YOLOX training loader against the JAX package's.

For the same records and seed the port's ``YoloxTrainLoader`` yields the
JAX loader's batches bit for bit (images, cxcywh boxes, labels, valid
masks): with the BOP'22 recipe's augmentation (mosaic and mixup at 1.0,
HSV, flip, the random affine with its mosaic scale), with the constructor's
defaults (mixup at 0.5), and with augmentation off (what the trainer's
no-aug switch leaves: letterboxed images). ``close()`` ends the worker
thread.
"""

import dataclasses

import numpy as np
import pytest

from gdrnpp_bop2022_tpu.datasets.bop_data import index_bop_split as j_index
from gdrnpp_bop2022_tpu.datasets.yolox_loader import YoloxTrainLoader as JLoader
from gdrnpp_bop2022_tpu.datasets.yolox_loader import det_records_from_instances as j_recs
from gdrnpp_bop2022_torch.config import YoloxAugConfig
from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
from gdrnpp_bop2022_torch.datasets.meta import DatasetMeta
from gdrnpp_bop2022_torch.datasets.yolox_loader import YoloxTrainLoader, \
    det_records_from_instances
from synth_utils import build_synth_bop

N_BATCHES = 3


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolox_loader") / "synth"
    syn = build_synth_bop(root, split="train_pbr", n_images=4, seed=3)
    jm = syn["meta"]
    meta = DatasetMeta(name="synth", id2obj=dict(jm.id2obj), width=jm.width,
                       height=jm.height, camera_matrix=jm.camera_matrix)
    return (j_recs(j_index(syn["split_dir"], jm)),
            det_records_from_instances(index_bop_split(syn["split_dir"], meta)))


def _batches(loader, n=N_BATCHES):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


@pytest.mark.parametrize("kind", ["recipe", "defaults", "no_aug"])
def test_batches_equal_jax(records, kind):
    jrecs, trecs = records
    kw = {"recipe": dataclasses.asdict(YoloxAugConfig()), "defaults": {},
          "no_aug": {"enable_aug": False}}[kind]
    kw = dict(kw, batch_size=4, input_size=96, max_gt=12, seed=7)
    port = YoloxTrainLoader(trecs, **kw)
    want, got = _batches(JLoader(jrecs, **kw)), _batches(port)
    assert not port._thread.is_alive()
    for w, g in zip(want, got):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    valid = np.concatenate([g["gt_valid"] for g in got])
    assert valid.sum() > 0
    if kind == "no_aug":
        # letterboxed 160x120 images: the canvas below row 72 stays grey
        assert (np.stack([g["images"] for g in got])[:, :, 73:] == 114).all()
