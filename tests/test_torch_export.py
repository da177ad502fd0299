"""Port parity: B1 as the operator ``gdrnpp::layer_norm`` and the exported
GDRN forward (``tools/export_model.py``) on the CPU.

  * The operator's CPU implementation (the plain version) equals
    ``layer_norm_ref``; its statistics equal a float64 recomputation at
    1e-5; its gradient (``register_autograd``: the plain backward on the CPU)
    equals ``jax.grad`` through the JAX ``LayerNormFp32`` at 1e-5;
    ``torch.library.opcheck`` passes (schema, fake implementation,
    autograd registration).
  * A tiny GDRN holding JAX parameters is exported by the CLI
    (``--weights``), saved, reloaded and run: equal to the eager port to
    1e-6 of each output's scale (the same operations), and to the JAX
    forward at 1e-4 of it, as ``tests/test_torch_gdrn.py`` holds the eager
    model; the saved program calls ``gdrnpp.layer_norm`` once per LayerNorm
    (22 in convnext_tiny) and carries no copy of the weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gdrnpp_bop2022_torch.ops import layer_norm as ln
from gdrnpp_bop2022_torch.tools import export_model
from torch_parity_utils import jax_gdrn_params, port_gdrn, roi_batch, tiny_cfg


@pytest.fixture(scope="module", autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ln_case(shape, seed):
    rs = np.random.RandomState(seed)
    C = shape[-1]
    return ((rs.randn(*shape) * 2 + 0.5).astype(np.float32),
            (1 + 0.1 * rs.randn(C)).astype(np.float32), (0.1 * rs.randn(C)).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape", [(5, 7, 96), (2, 3, 5, 128)])
def test_op_forward_statistics_and_gradient(shape):
    from gdrnpp_bop2022_tpu.models.backbones.convnext import LayerNormFp32
    x, w, b, dy = _ln_case(shape, sum(shape))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    y, mean, rstd = torch.ops.gdrnpp.layer_norm(xt, wt, bt, 1e-6, True)
    torch.testing.assert_close(y, ln.layer_norm_ref(xt, wt, bt), rtol=0, atol=0)
    x64 = x.astype(np.float64).reshape(-1, shape[-1])
    np.testing.assert_allclose(mean.detach().numpy(), x64.mean(1), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(rstd.detach().numpy(), 1 / np.sqrt(x64.var(1) + 1e-6), rtol=1e-5)
    y.backward(torch.from_numpy(dy))

    mod = LayerNormFp32()

    def f(x_, w_, b_):
        out = mod.apply({"params": {"LayerNorm_0": {"scale": w_, "bias": b_}}}, x_)
        return jnp.sum(out * dy)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    for got, ref in zip((xt.grad, wt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # without statistics the op writes none, and has no gradient to give
    y2, m2, r2 = torch.ops.gdrnpp.layer_norm(xt.detach(), wt.detach(), bt.detach(), 1e-6, False)
    assert m2.numel() == r2.numel() == 0 and torch.equal(y2, y.detach())


def test_opcheck_and_wrapper():
    x, w, b, _ = _ln_case((6, 32), 3)
    args = (torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True),
            torch.from_numpy(b), 1e-6, True)
    torch.library.opcheck(torch.ops.gdrnpp.layer_norm.default, args)
    # the wrapper takes statistics only where a gradient will be taken
    with torch.no_grad():
        y = ln.layer_norm(*args[:3])
    assert torch.equal(y, ln.layer_norm_ref(*args[:3]))
    assert ln.layer_norm(*args[:3]).grad_fn is not None


def test_exported_forward_matches_eager_and_jax(tmp_path):
    cfg = tiny_cfg()
    jm, params = jax_gdrn_params(cfg, seed=0)
    port = port_gdrn(cfg, params)
    wpath = tmp_path / "tiny.pth"
    torch.save({"model": port.state_dict()}, wpath)
    pc = cfg.model.pose_net
    opts = [f"model.pose_net.num_classes={pc.num_classes}", f"model.pose_net.input_res={pc.input_res}",
            f"model.pose_net.output_res={pc.output_res}", "model.pose_net.backbone.name='convnext_tiny'",
            "model.pose_net.geo_head.feat_dim=32", "model.pose_net.geo_head.num_gn_groups=8",
            "model.pose_net.geo_head.num_regions=8", "model.pose_net.pnp_net.featdim=32",
            "model.pose_net.pnp_net.num_gn_groups=8", "model.compute_dtype='float32'"]
    out = str(tmp_path / "export")
    res = export_model.main(["--weights", str(wpath), "--out", out, "--batch-size", "3",
                             "--device", "cpu", "--opts", *opts])
    assert res["err"] <= 1e-6
    program, state = res["program"], res["state"]      # reloaded by the CLI's self-check
    assert sum("gdrnpp.layer_norm" in str(n.target) for n in program.graph.nodes) == 22
    assert (tmp_path / "export" / export_model.PROGRAM).stat().st_size < 5e6   # no weights

    b = roi_batch(cfg, B=3, seed=1)
    b["roi_labels"] = b["roi_labels"].astype(np.int64)
    inputs = tuple(torch.from_numpy(b[k]) for k in export_model.INPUTS)
    with torch.inference_mode():
        rot, trans = program(state, *inputs)
        eager = port(*inputs)
    want = jax.jit(jm.apply)({"params": params}, **{k: jnp.asarray(v) for k, v in b.items()})
    for k, got in (("rot", rot), ("trans", trans)):
        w = np.asarray(want[k])
        scale = max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(got.numpy(), eager[k].numpy(), rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4 * scale, err_msg=k)
