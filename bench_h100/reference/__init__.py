"""The benchmark's plain reference of GDRN pose serving, in fp32 PyTorch.

It follows GDRNPP's published test path (ROI crop, ConvNeXt backbones, the
top-down double-mask XYZ/region head, ConvPnPNet, the SITE decode, and the
BOP'22 depth refinement) and imports nothing of the package it checks.
"""
