"""Data-parallel training and eval: one process per card, joined by
``torch.distributed`` (port of ``gdrnpp_bop2022_tpu/parallel``)."""

from .distributed import (all_reduce_sum, broadcast_module, gather_results, global_sum,
                          initialize_distributed, is_main_process, mean_over_ranks, rank,
                          shutdown, sync_grads, world_size)
from .mesh import Mesh, make_mesh, shard_batch
