"""Channel orders that differ between the reference's layout and the JAX
package's (numpy only).

The port's copies of ``gdrnpp_bop2022_tpu/utils/torch_port.py::
geo_out_channel_perm`` and ``focus_input_perm``: the port keeps the
reference's layouts (the geo head's group-major out conv, YOLOX's Focus
order), the JAX package other ones, and these permutations map one onto the
other (the geo head's weight gather and the weight bridges use them).
"""

from __future__ import annotations

import numpy as np


def geo_out_channel_perm(mask_out_dim: int, xyz_out_dim: int,
                         region_out_dim: int, mask_nc: int = 1,
                         xyz_nc: int = 1, region_nc: int = 1,
                         double_mask: bool = True) -> np.ndarray:
    """Channel permutation from the reference's shared out-conv layout to
    the JAX package's.

    Reference layout (group-major): [vis(c0..cN), full(c0..cN),
    x(c0..cN x bins), y(...), z(...), region(c0..cN)], each sub-block
    class-major. JAX layout (class-major): per class [vis, full] | per class
    [x-bins, y-bins, z-bins] | per class [region]. A single-mask head
    (``double_mask=False``) has one mask block of ``mask_out_dim`` channels
    per class, class-major in both layouts.

    Returns perm with jax_channel[i] = ref_channel[perm[i]].
    """
    pk = xyz_out_dim // 3
    perm = []
    if double_mask:
        # mask group: class-major (vis md2, full md2) per class
        md2 = mask_out_dim // 2
        for c in range(mask_nc):
            perm += [c * md2 + j for j in range(md2)]
            perm += [mask_nc * md2 + c * md2 + j for j in range(md2)]
    else:
        perm += list(range(mask_nc * mask_out_dim))
    # xyz group: class-major (x pk, y pk, z pk) per class; the reference is
    # axis-major then class-major
    xyz_base = len(perm)
    for c in range(xyz_nc):
        for k in range(3):
            perm += [xyz_base + k * (xyz_nc * pk) + c * pk + i
                     for i in range(pk)]
    # region group: class-major in both
    reg_base = xyz_base + 3 * xyz_nc * pk
    for c in range(region_nc):
        perm += [reg_base + c * region_out_dim + j
                 for j in range(region_out_dim)]
    return np.asarray(perm, np.int64)


def focus_input_perm(C: int = 3) -> np.ndarray:
    """Input-channel permutation of YOLOX's stem conv.

    The port's copy of ``gdrnpp_bop2022_tpu/utils/torch_port.py::
    focus_input_perm``. The reference's Focus (and the port's) concatenates
    the pixel-unshuffle blocks as [top-left, bottom-left, top-right,
    bottom-right], channel g * C + c; the JAX package's ``focus_rearrange``
    flattens (dy, dx, c) row-major. Returns perm with
    jax_channel[i] = ref_channel[perm[i]].
    """
    g_of = {(0, 0): 0, (1, 0): 1, (0, 1): 2, (1, 1): 3}
    perm = np.empty(4 * C, np.int64)
    for dy in range(2):
        for dx in range(2):
            for c in range(C):
                perm[dy * 2 * C + dx * C + c] = g_of[(dy, dx)] * C + c
    return perm
