"""Process groups and the cross-rank helpers of data-parallel training and eval.

Port of ``gdrnpp_bop2022_tpu/parallel/distributed.py`` in PyTorch's idiom:
one process per card, joined by ``torch.distributed``. NCCL carries the
card's tensors and gloo the CPU's; host objects (eval rows) always go over a
gloo group, so two eval processes can share one card.

Under the JAX mesh a step's loss is taken over the global batch. Here each
rank holds an equal slice of it, the gradients are averaged over the ranks
(``sync_grads``, as DDP does), and every term is written so that the ranks'
average of its local value is the global batch's: a plain mean over the
batch axis as it is, and a masked sum over a count as the local sum times
the world size over the count summed over every rank (``global_sum``). A
BatchNorm takes its statistics over the global batch through
``all_reduce_sum``, whose backward sums the gradients over the ranks too.
In a world of one every helper is the identity.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

_GLOO = None        # the gloo group of host-object gathers (the world group under gloo)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    With no arguments it reads torchrun's ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR`` / ``MASTER_PORT`` (as the JAX package reads
    ``COORDINATOR_ADDRESS``); ``coordinator_address`` is "host:port". One
    process is a no-op. ``backend``: NCCL when the card is there, else gloo
    (gloo on the card too when two ranks share one, which NCCL refuses)."""
    global _GLOO
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ.get("RANK", 0))
    if not num_processes or num_processes <= 1:
        return 0, 1
    if process_id is None:
        raise ValueError("initialize_distributed: a world of several processes needs process_id")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id)
    _GLOO = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")
    return dist.get_rank(), dist.get_world_size()


def add_distributed_args(ap) -> None:
    """A CLI's flags for a run of several processes (torchrun's environment
    stands in for them)."""
    ap.add_argument("--num-processes", type=int, default=None,
                    help="processes in the run (one per card; with --coordinator and "
                         "--process-id); torchrun's WORLD_SIZE otherwise")
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="NCCL on the card, gloo on the CPU (default); gloo lets two "
                         "ranks share one card")


def init_from_args(args, backend: Optional[str] = None) -> Tuple[int, int, str]:
    """``initialize_distributed`` from ``add_distributed_args``'s flags;
    returns (rank, world size, device). ``--device cuda`` under torchrun is
    ``cuda:LOCAL_RANK``. ``backend`` is the default of ``--dist-backend``."""
    device = args.device
    backend = args.dist_backend or backend or ("nccl" if device.startswith("cuda") else "gloo")
    if device == "cuda" and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    if torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    r, w = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                  backend)
    return r, w, device


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def _all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place; a card tensor under gloo goes
    through the host."""
    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank, without gradient (a loss's masked count
    over the global batch); ``x`` itself in a world of one."""
    if world_size() == 1:
        return x
    return _all_reduce_(x.detach().clone())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over every rank, differentiable: the backward sums the
    ranks' gradients (with the gradients averaged over the ranks after the
    backward, a statistic of the global batch gets the global loss's
    gradient). The identity in a world of one."""
    return x if world_size() == 1 else _AllReduceSum.apply(x)


def sync_grads(params) -> None:
    """Average the gradients over the ranks (one flat all-reduce); a no-op
    in a world of one. Every rank must hold gradients for the same
    parameters."""
    w = world_size()
    if w == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce_(flat).div_(w)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank (DDP's start)."""
    if world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            if t.is_cuda and dist.get_backend() == "gloo":
                host = t.detach().cpu()
                dist.broadcast(host, 0)
                t.copy_(host)
            else:
                dist.broadcast(t.data, 0)


def mean_over_ranks(metrics: dict) -> dict:
    """Each 0-d tensor of ``metrics`` averaged over the ranks (the global
    batch's value of a loss written as above); as it is in a world of one."""
    w = world_size()
    if w == 1:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    _all_reduce_(flat).div_(w)
    return {k: flat[i] for i, k in enumerate(keys)}


def gather_results(local_rows: list) -> list:
    """The rows of every rank concatenated in rank order, on every rank
    (over the gloo group); the rows themselves in a world of one."""
    w = world_size()
    if w == 1:
        return list(local_rows)
    parts: List[Optional[list]] = [None] * w
    dist.all_gather_object(parts, local_rows, group=_GLOO)
    return [row for part in parts for row in part]


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_GLOO)


def shutdown() -> None:
    """Leave the process group (at the end of a run of several processes)."""
    global _GLOO
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GLOO = None

