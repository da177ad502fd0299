"""The CLIs over two gloo processes on the CPU, against one process, on a
synthetic split of 3 images:

* ``test_gdrn --num-processes 2``: rank 0's poses.csv holds the single
  process's rows (R and t within 1e-5 of each row's largest: the ranks
  serve batches of another composition, and the CPU's convolutions may
  block them otherwise) and its stats.json the counts summed over the
  ranks; rank 1 returns its gathered rows and writes nothing;
* ``train_gdrn --num-processes 2``: the trainer's data mesh (see the test's
  docstring for its tolerances).
"""

import csv
import json
import os

import numpy as np
import torch

from test_torch_parallel import _spawn
from test_torch_parallel import TINY as TRAIN_TINY

def _synth(root) -> str:
    """The synthetic split, and its dataset's meta file for ``--dataset-meta``."""
    from synth_utils import build_synth_bop
    syn = build_synth_bop(os.path.join(root, "synthpar"), n_images=3, seed=13)
    jm = syn["meta"]
    path = os.path.join(root, "synthpar.json")
    with open(path, "w") as f:
        json.dump({"name": "synthpar", "id2obj": {str(k): v for k, v in jm.id2obj.items()},
                   "width": jm.width, "height": jm.height,
                   "camera_matrix": np.asarray(jm.camera_matrix).ravel().tolist()}, f)
    return path


def _test_gdrn_args(root, out, meta_file):
    opts = ["model.pose_net.num_classes=2", "model.pose_net.input_res=64",
            "model.pose_net.output_res=16", "model.pose_net.backbone.name=convnext_tiny",
            "model.pose_net.geo_head.feat_dim=32", "model.pose_net.geo_head.num_gn_groups=8",
            "model.pose_net.geo_head.num_regions=8", "model.pose_net.pnp_net.featdim=32",
            "model.pose_net.pnp_net.num_gn_groups=8", "model.compute_dtype=float32"]
    return ["--opts", *opts, f"datasets.root={root!r}", "datasets.test=('synthpar_test',)",
            "model.load_dets_test=False", f"output_dir={out!r}", "--seed", "0",
            "--device", "cpu", "--dataset-meta", meta_file]


def _test_gdrn_worker(rank, port, root, meta_file):
    from gdrnpp_bop2022_torch.tools import test_gdrn
    torch.set_num_threads(2)
    test_gdrn.main([*_test_gdrn_args(root, os.path.join(root, "multi"), meta_file),
                    "--num-processes", "2", "--process-id", str(rank),
                    "--coordinator", f"localhost:{port}"])


def _csv_rows(path):
    with open(path) as f:
        return {(int(r["im_id"]), int(r["obj_id"])): r for r in csv.DictReader(f)}


def test_test_gdrn_two_processes_equal_one(tmp_path):
    from gdrnpp_bop2022_torch.tools import test_gdrn
    torch.set_num_threads(2)
    root = str(tmp_path)
    meta_file = _synth(root)
    results, _ = test_gdrn.main(_test_gdrn_args(root, os.path.join(root, "single"), meta_file))
    _spawn(_test_gdrn_worker, root, meta_file)
    inf = os.path.join("inference", "synthpar_test")
    one = _csv_rows(os.path.join(root, "single", inf, "poses.csv"))
    two = _csv_rows(os.path.join(root, "multi", inf, "poses.csv"))
    assert len(one) == len(results) == 6 and one.keys() == two.keys()
    for k in one:
        for f in ("R", "t"):
            a = np.array(one[k][f].split(), float)
            b = np.array(two[k][f].split(), float)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())
    with open(os.path.join(root, "multi", inf, "stats.json")) as f:
        stats = json.load(f)
    assert stats["n_rois"] == 6 and stats["processes"] == 2 and stats["forwards"] >= 2


def _train_args(root, out, meta_file):
    opts = [f"{k}={v!r}" for k, v in TRAIN_TINY.items()] + [
        f"datasets.root={root!r}", "datasets.train=('synthpar_test',)", "datasets.train2=()",
        "datasets.test=('synthpar_test',)", f"output_dir={out!r}", "solver.ims_per_batch=4",
        "train.log_period=1", "train.num_workers=1", "input.color_aug.prob=0.8"]
    return ["--config", "default", "--opts", *opts, "--max-iters", "2", "--device", "cpu",
            "--dataset-meta", meta_file]


def _train_worker(rank, port, root, meta_file):
    from gdrnpp_bop2022_torch.tools import train_gdrn
    torch.set_num_threads(2)
    out = os.path.join(root, "train2")
    train_gdrn.main([*_train_args(root, out, meta_file), "--num-processes", "2",
                     "--process-id", str(rank), "--coordinator", f"localhost:{port}"])


def test_train_gdrn_cli_world2_equals_world1(tmp_path):
    """``tools.train_gdrn`` over two gloo processes against one: the same
    global batches and colour-augmentation draws, each rank on its half; the
    step-1 loss (averaged over the ranks) within 1e-5 relative, the
    checkpoint's parameters after 2 SGD steps within 1e-5 of each tensor's
    largest, only rank 0 writing metrics and checkpoints."""
    from gdrnpp_bop2022_torch.tools import train_gdrn
    torch.set_num_threads(2)
    root = str(tmp_path)
    meta_file = _synth(root)
    state = train_gdrn.main(_train_args(root, os.path.join(root, "train1"), meta_file))
    _spawn(_train_worker, root, meta_file)
    rows = {}
    for w in ("train1", "train2"):
        with open(os.path.join(root, w, "metrics.json")) as f:
            rows[w] = [json.loads(line) for line in f]
        assert [r["iteration"] for r in rows[w]] == [1, 2]
    l1, l2 = rows["train1"][0]["total_loss"], rows["train2"][0]["total_loss"]
    assert abs(l2 - l1) <= 1e-5 * abs(l1), (l1, l2)
    ck = [torch.load(os.path.join(root, w, "ckpt", "ckpt_00000002.pth"), weights_only=False)
          for w in ("train1", "train2")]
    for k, v in ck[0]["model"].items():
        if v.is_floating_point():
            err = float((ck[1]["model"][k] - v).abs().max())
            assert err <= 1e-5 * max(float(v.abs().max()), 1e-12), (k, err)
    assert state.step == 2
    stats = [json.load(open(os.path.join(root, "train2", f"stats_rank{r}.json")))
             for r in range(2)]
    assert [s["rank"] for s in stats] == [0, 1] and all(s["world"] == 2 for s in stats)
    assert sorted(os.listdir(os.path.join(root, "train2", "ckpt"))) == ["ckpt_00000002.pth"]
