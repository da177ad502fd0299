"""gdrnpp_bop2022_torch — the PyTorch/CUDA port of gdrnpp_bop2022_tpu.

Stage-1 detection (YOLOX), stage-2 ROI pose inference and training (GDRN)
and BOP scoring for one NVIDIA H100, held against the JAX package in parity
tests. It imports torch and never jax. The Pallas
TPU kernels are replaced by kernels written by hand for Hopper
(``csrc/``, built with nvcc at first use, see ``utils/cuda_build.py``);
everything else is plain PyTorch.
"""
