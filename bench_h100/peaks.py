"""Published peaks of the cards the benchmark knows, by ``torch.cuda.get_device_name()``.

NVIDIA H100 SXM5 80GB (its datasheet): 989.4 TFLOP/s dense bf16 on the
tensor cores, 3.35 TB/s of HBM3 bandwidth. A card not listed has no peak:
the metrics that need one are left out of its results.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str, key: str):
    return PEAKS.get(device_name, {}).get(key)
