"""``engine.yolox_trainer.train_yolox`` over two gloo processes on the CPU
against one process, on a synthetic ycbv train split of 4 images (yolox_s,
64^2, BN in training, SGD, mosaic and mixup from the seed, precise BN over
one clean batch before the in-train eval at the last iteration): every rank
draws the same global batch of 4 and trains on its 2 images with the global
batch's BN statistics and foreground count.

Held: the metrics rank 0 writes (averaged over the ranks) against world 1's
within 1e-5 relative on each loss; the final checkpoint's parameter updates
within 1e-3 of each tensor's largest update plus two fp32 ulps at 1.0, and
its BN running statistics within 1e-3 of each tensor's largest (the second
step's statistics come from parameters that already carry the first
update's differences; measured 1.1e-4 on a mean of 0.02): a BN backward
through ~70 layers amplifies summation order (``test_torch_parallel.py``
reads the same on one step). Only rank 0 writes metrics and checkpoints and
runs the eval; precise BN runs on both ranks, over their slices.
"""

import json
import os

import torch

from test_torch_parallel import _spawn

KW = dict(num_classes=21, size="yolox_s", input_size=64, batch_size=4, base_lr=0.02 / 64,
          optimizer="sgd", log_period=1, ckpt_period=100, norm="BN", eval_period=2,
          precise_bn_iters=1, seed=3, device="cpu")


def _records(root):
    from gdrnpp_bop2022_torch.datasets.bop_data import index_bop_split
    from gdrnpp_bop2022_torch.datasets.meta import get_meta
    from gdrnpp_bop2022_torch.datasets.yolox_loader import det_records_from_instances
    return det_records_from_instances(index_bop_split(
        os.path.join(root, "ycbv", "train_pbr"), get_meta("ycbv")))


def _train(root, out):
    from gdrnpp_bop2022_torch.engine.yolox_trainer import train_yolox
    evals = []
    train_yolox(_records(root), output_dir=out, total_iters=2,
                eval_fn=lambda w, it: evals.append(it) or {"AP50": 0.5}, **KW)
    return evals


def _worker(rank, port, root):
    from test_torch_parallel import _join
    from gdrnpp_bop2022_torch.parallel import shutdown
    _join(rank, port)
    evals = _train(root, os.path.join(root, "w2"))
    with open(os.path.join(root, f"evals{rank}.json"), "w") as f:
        json.dump(evals, f)
    shutdown()


def _close(got, want, tol, what, floor=0.0):
    for n in want:
        if not want[n].is_floating_point():
            continue
        scale = max(float(want[n].abs().max()), 1e-12)
        err = float((got[n] - want[n]).abs().max())
        assert err <= tol * scale + floor, (what, n, err / scale)


def test_train_yolox_world2_equals_world1(tmp_path):
    from gdrnpp_bop2022_torch.engine.yolox_trainer import init_yolox_weights
    from gdrnpp_bop2022_torch.models.yolox import build_yolox
    from synth_utils import build_synth_bop
    torch.set_num_threads(2)
    root = str(tmp_path)
    build_synth_bop(os.path.join(root, "ycbv"), split="train_pbr", n_images=4, seed=5)
    assert _train(root, os.path.join(root, "w1")) == [2]
    _spawn(_worker, root)
    assert [json.load(open(os.path.join(root, f"evals{r}.json"))) for r in range(2)] == [[2], []]
    rows = {}
    for w in ("w1", "w2"):
        with open(os.path.join(root, w, "metrics_yolox.json")) as f:
            rows[w] = [json.loads(line) for line in f if "total_loss" in line]
        assert [r["iteration"] for r in rows[w]] == [1, 2]
    for a, b in zip(rows["w1"], rows["w2"]):
        for k in ("loss_iou", "loss_obj", "loss_cls", "total_loss"):
            assert abs(b[k] - a[k]) <= 1e-5 * abs(a[k]), (k, a[k], b[k])
    model = build_yolox(21, "yolox_s", norm="BN", device="cpu", dtype=torch.float32)
    init_yolox_weights(model, KW["seed"])
    p0 = model.state_dict()
    ck = [torch.load(os.path.join(root, w, "ckpt_yolox", "ckpt_00000002.pth"),
                     weights_only=False) for w in ("w1", "w2")]
    params = [n for n, _ in model.named_parameters()]
    upd = [{n: c["model"][n] - p0[n] for n in params} for c in ck]
    _close(upd[1], upd[0], 1e-3, "updates", floor=2.4e-7)
    stats = [{n: c["model"][n] for n in c["model"] if "running" in n} for c in ck]
    _close(stats[1], stats[0], 1e-3, "stats")
    assert os.listdir(os.path.join(root, "w2", "ckpt_yolox")) == ["ckpt_00000002.pth"]
