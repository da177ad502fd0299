"""Channel-last LayerNorm: kernel B1 (forward and backward) and its plain version.

``layer_norm`` normalises the last axis of ``x`` with fp32 statistics
(eps 1e-6 by default) and returns ``x.dtype``. It is the port of
``gdrnpp_bop2022_tpu/ops/pallas_ln.py::layer_norm_pallas`` and is what
ConvNeXt's 40 LayerNorms call.

B1 is the operator ``torch.ops.gdrnpp.layer_norm(x, weight, bias, eps,
with_stats) -> (y, mean, rstd)``, registered with ``torch.library`` when
this module is imported, so ``torch.export`` traces it as one node and a saved program
calls it again when it is loaded (import this module first):

  * its CUDA implementation launches the hand-written kernel of
    ``csrc/layer_norm.cu`` (built with nvcc at first use), or raises: there
    is no fallback on the card. ``_vector_path`` picks the kernel's path:
    16-byte accesses where C and every pointer allow them, else one element
    per access;
  * its CPU implementation is the plain version, ``layer_norm_ref`` (fp32
    upcast, ``F.layer_norm``, cast back);
  * its fake implementation gives the shapes to tracers;
  * its autograd formula is the backward kernel (``layer_norm_backward``)
    on the card with the per-row fp32 mean and rstd that the forward saved
    (``with_stats``), and ``layer_norm_backward_ref`` on the CPU. Without a
    gradient to take, the forward writes no statistics (``mean`` and
    ``rstd`` come back empty).

The backward on the card is bound by the bytes it moves (x and dy read,
dx written), and a training step's 40 calls take 5.6-45 us each at that
bound, so what a call costs besides its bytes matters as much. On the
vector path (every main-path call) it is one design: a persistent grid of
``bwd_scratch_rows(...)`` blocks (two per SM where a row is at most 1 KB,
else one; never more than the call has tiles) in which a producer warp
keeps a two-stage ring of row tiles in shared memory filled with bulk
copies while eight warps compute dx from it; each block keeps its dweight /
dbias sums in registers across its tiles and writes one (C,) row per
output into an fp32 scratch that this wrapper allocates for the call
(``2 x blocks x C`` floats, 132-264 rows on an H100); a second launch sums
those rows in a fixed block order, so two runs give the same bits. The SM
count behind the plan is read once per device. The scalar path (a C whose
row is not whole 16-byte vectors, or a misaligned pointer) keeps the first
design: an occupancy-sized grid with a 1024-row scratch.

``layer_norm.launches`` counts forward kernel launches;
``layer_norm_backward.launches`` counts launches of the backward's rows
kernel (``layer_norm_bwd_tiles`` on the vector path, ``layer_norm_bwd_rows``
on the scalar path) and ``layer_norm_backward.reduce_launches`` the
launches of its fixed-order reduction of dweight/dbias over the rows
kernel's blocks (``layer_norm_bwd_reduce``), one each a call;
``layer_norm_backward.dy_copies`` counts incoming gradients that were not
contiguous (rows, C) and had to be copied.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_CHANNELS = 1024
MAX_BWD_BLOCKS = 1024          # csrc/layer_norm.cu kMaxBwdBlocks (the scalar path)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fns = None
_sm_counts = {}


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis in fp32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                        eps).to(x.dtype)


def layer_norm_backward_ref(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                            eps: float = 1e-6):
    """Plain backward: autograd through ``layer_norm_ref``. Returns
    (dx in x's dtype, dweight fp32, dbias fp32)."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        w = weight.detach().float().requires_grad_(True)
        b = torch.zeros_like(w, requires_grad=True)
        y = layer_norm_ref(xr, w, b, eps)
        return torch.autograd.grad(y, (xr, w, b), dy)


def _kernels():
    global _fns
    if _fns is None:
        from ..utils.cuda_build import load_kernel_library
        lib = load_kernel_library("layer_norm")
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd = lib.gdrn_layer_norm_fwd
        fwd.argtypes = [p, p, p, p, p, p, i, i, ctypes.c_float, i, i, p]
        fwd.restype = i
        bwd = lib.gdrn_layer_norm_bwd
        bwd.argtypes = [p, p, p, p, p, p, p, i, p, p, i, i, i, i, p]
        bwd.restype = i
        _fns = (fwd, bwd)
    return _fns


def _vector_path(*tensors) -> bool:
    """True where the kernel can move 16 bytes per access: a row of C
    values is a whole number of 16-byte vectors (C % 8 in bf16, C % 4 in
    fp32; C and the element size from the first tensor) and every tensor
    starts on a 16-byte boundary (for the backward also mean and rstd, which
    its bulk copies read in 16-byte groups)."""
    x = tensors[0]
    return ((x.shape[-1] * x.element_size()) % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def bwd_scratch_rows(rows: int, C: int, element_size: int, vector: bool, sms: int) -> int:
    """Rows of the backward's fp32 scratch per output for (rows, C) of
    elements of ``element_size`` bytes on a card of ``sms`` SMs: on the
    vector path the persistent grid's blocks, two per SM where a row is at
    most 1 KB, else one (never more than ``rows``; csrc/layer_norm.cu cuts
    the grid further to the call's tiles of 8-32 rows), one scratch row
    each; on the scalar path MAX_BWD_BLOCKS, the most its occupancy-sized
    grid launches."""
    if not vector:
        return MAX_BWD_BLOCKS
    return min((2 if C * element_size <= 1024 else 1) * sms, rows)


def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once per device."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _sm_counts:
        _sm_counts[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _sm_counts[i]


def _check_cuda_args(x, weight, bias):
    C = x.shape[-1]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"layer_norm kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel needs x contiguous with channels "
                         f"last; got shape {tuple(x.shape)} strides {x.stride()}")
    if not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"layer_norm kernel takes 0 < C <= {MAX_CHANNELS}, got {C}")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if p.dtype != torch.float32 or p.shape != (C,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({C},) float32 "
                             f"tensor, got {p.dtype} {tuple(p.shape)}")
    if x.numel() // C > torch.iinfo(torch.int32).max:
        raise ValueError("layer_norm kernel takes fewer than 2**31 rows")


def _forward_cuda(x, weight, bias, eps, with_stats: bool):
    """One forward launch: y, and (mean, rstd) (rows,) fp32 when with_stats."""
    _check_cuda_args(x, weight, bias)
    y = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    mean = rstd = None
    if with_stats:
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    with torch.cuda.device(x.device):
        err = _kernels()[0](x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                            mean.data_ptr() if with_stats else None,
                            rstd.data_ptr() if with_stats else None,
                            rows, x.shape[-1], float(eps), _DTYPE_CODE[x.dtype],
                            int(_vector_path(x, y, weight, bias)),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1
    return y, mean, rstd


def layer_norm_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                        mean: torch.Tensor, rstd: torch.Tensor, eps: float = 1e-6):
    """VJP of ``layer_norm`` at x: (dx in x's dtype, dweight, dbias fp32).

    On the card: the backward kernel with the forward's saved fp32 mean and
    rstd (contiguous (rows,)) and ``bwd_scratch_rows`` rows of scratch; a dy
    that is not contiguous is copied first (counted in
    ``layer_norm_backward.dy_copies``).
    On the CPU: ``layer_norm_backward_ref`` (mean and rstd unused)."""
    if x.device.type == "cpu":
        return layer_norm_backward_ref(dy, x, weight, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm_backward runs on cpu or cuda, got {x.device}")
    C = x.shape[-1]
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x {tuple(x.shape)}")
    if dy.dtype != x.dtype:
        raise TypeError(f"dy is {dy.dtype}, x is {x.dtype}")
    if not dy.is_contiguous():
        dy = dy.contiguous()
        layer_norm_backward.dy_copies += 1
    _check_cuda_args(x, weight, weight)
    rows = x.numel() // C
    for name, s in (("mean", mean), ("rstd", rstd)):
        if (s.dtype != torch.float32 or s.shape != (rows,) or s.device != x.device
                or not s.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({rows},) float32 tensor on "
                             f"{x.device}")
    dx = torch.empty_like(x)
    dw = torch.empty(C, dtype=torch.float32, device=x.device)
    db = torch.empty_like(dw)
    if rows == 0:
        return dx, dw.zero_(), db.zero_()
    vector = _vector_path(x, dy, weight, dx, mean, rstd)
    scratch = bwd_scratch_rows(rows, C, x.element_size(), vector, _sm_count(x.device))
    partial = torch.empty(2 * scratch * C, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _kernels()[1](x.data_ptr(), dy.data_ptr(), weight.data_ptr(), mean.data_ptr(),
                            rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                            scratch, dw.data_ptr(), db.data_ptr(), rows, C,
                            _DTYPE_CODE[x.dtype], int(vector),
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm backward kernel launch failed: cudaError {err}")
    layer_norm_backward.launches += 1
    layer_norm_backward.reduce_launches += 1
    return dx, dw, db


layer_norm_backward.launches = 0
layer_norm_backward.reduce_launches = 0
layer_norm_backward.dy_copies = 0


def _stats_ref(x: torch.Tensor, eps: float):
    """Plain per-row fp32 mean and rstd, as the kernel saves them."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean = xf.mean(dim=1)
    return mean, torch.rsqrt(((xf - mean[:, None]) ** 2).mean(dim=1) + eps)


# The operator is defined with torch.library.Library rather than the
# @torch.library.custom_op decorator: the decorator runs each implementation
# inside torch._dynamo's "disable" wrapper, whose first call imports
# torch._dynamo (seconds, in every process that serves). The registrations
# are the same: schema, CUDA and CPU implementations, fake, autograd.
_LIB = torch.library.Library("gdrnpp", "DEF")
_LIB.define("layer_norm(Tensor x, Tensor weight, Tensor bias, float eps, bool with_stats) "
            "-> (Tensor, Tensor, Tensor)")


def _layer_norm_cuda(x, weight, bias, eps, with_stats):
    y, mean, rstd = _forward_cuda(x, weight, bias, eps, with_stats)
    if not with_stats:
        mean, rstd = (x.new_empty(0, dtype=torch.float32) for _ in range(2))
    return y, mean, rstd


def _layer_norm_cpu(x, weight, bias, eps, with_stats):
    # The CPU backward does not read mean and rstd; they are computed so the
    # op gives the outputs its schema and fake promise on every device.
    mean, rstd =(_stats_ref(x, eps) if with_stats else
                  (x.new_empty(0, dtype=torch.float32) for _ in range(2)))
    return layer_norm_ref(x, weight, bias, eps), mean, rstd


def _layer_norm_fake(x, weight, bias, eps, with_stats):
    rows = x.numel() // x.shape[-1] if with_stats else 0
    return (torch.empty_like(x), x.new_empty(rows, dtype=torch.float32),
            x.new_empty(rows, dtype=torch.float32))


_LIB.impl("layer_norm", _layer_norm_cuda, "CUDA")
_LIB.impl("layer_norm", _layer_norm_cpu, "CPU")
torch.library.register_fake("gdrnpp::layer_norm", _layer_norm_fake, lib=_LIB)


def _setup_context(ctx, inputs, output):
    x, weight, _, eps, with_stats = inputs
    if not with_stats:
        raise RuntimeError("gdrnpp::layer_norm was run without statistics "
                           "(with_stats=False); its backward needs them")
    ctx.save_for_backward(x, weight, output[1], output[2])
    ctx.eps = eps


def _backward(ctx, dy, _dmean, _drstd):
    x, weight, mean, rstd = ctx.saved_tensors
    dx, dw, db = layer_norm_backward(dy, x, weight, mean, rstd, ctx.eps)
    return dx, dw, db, None, None


torch.library.register_autograd("gdrnpp::layer_norm", _backward,
                                setup_context=_setup_context, lib=_LIB)
#: B1: (x, weight, bias, eps, with_stats) -> (y, mean, rstd); mean and rstd
#: (rows,) fp32 when with_stats, else empty
layer_norm_op = torch.ops.gdrnpp.layer_norm.default


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); weight, bias (C,) fp32:
    the operator ``gdrnpp::layer_norm``, with statistics where a gradient
    will be taken."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    with_stats = torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                              or bias.requires_grad)
    return layer_norm_op(x, weight, bias, eps, with_stats)[0]


layer_norm.launches = 0
