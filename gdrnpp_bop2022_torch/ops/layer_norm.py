"""Channel-last LayerNorm: kernel B1 and its plain version.

``layer_norm`` normalises the last axis of ``x`` with fp32 statistics
(eps 1e-6 by default) and returns ``x.dtype``. It is the port of
``gdrnpp_bop2022_tpu/ops/pallas_ln.py::layer_norm_pallas`` and is what
ConvNeXt's 40 LayerNorms call.

  * a tensor on the CPU goes to ``layer_norm_ref``: fp32 upcast,
    ``F.layer_norm``, cast back;
  * a tensor on a CUDA device goes to the hand-written kernel
    ``csrc/layer_norm.cu`` (built with nvcc at first use), or the call
    raises. There is no fallback on the card. ``_vector_path`` picks the
    kernel's path: 16-byte accesses where C and every pointer allow them,
    else one element per access.

``layer_norm.launches`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

MAX_CHANNELS = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def layer_norm_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain version: LayerNorm over the last axis in fp32, cast back."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                        eps).to(x.dtype)


def _kernel():
    global _fn
    if _fn is None:
        from ..utils.cuda_build import load_kernel_library
        fn = load_kernel_library("layer_norm").gdrn_layer_norm_fwd
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _vector_path(x, y, weight, bias) -> bool:
    """True where the kernel can move 16 bytes per access: a row of C
    values is a whole number of 16-byte vectors (C % 8 in bf16, C % 4 in
    fp32) and x, y, weight and bias all start on a 16-byte boundary."""
    return ((x.shape[-1] * x.element_size()) % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, y, weight, bias)))


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
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError("layer_norm kernel is forward-only; its "
                                  "backward arrives with GDRN training")
    if x.numel() // C > torch.iinfo(torch.int32).max:
        raise ValueError("layer_norm kernel takes fewer than 2**31 rows")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); weight, bias (C,) fp32."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm runs on cpu or cuda, got {x.device}")
    _check_cuda_args(x, weight, bias)
    y = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    if rows == 0:
        return y
    with torch.cuda.device(x.device):
        err = _kernel()(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                        y.data_ptr(), rows, x.shape[-1], float(eps),
                        _DTYPE_CODE[x.dtype], int(_vector_path(x, y, weight, bias)),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {err}")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
