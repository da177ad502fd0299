"""Command-line entry points of the port: ``python -m gdrnpp_bop2022_torch.tools.<name>``."""
