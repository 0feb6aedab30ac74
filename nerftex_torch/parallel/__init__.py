"""Parallelism on torch.distributed (counterpart of nerftex_tpu/parallel):
one process per device on a ("data", "model") mesh, the rays of a batch or
a frame split over "data" and the MLP trunk's width over "model".

``init_distributed`` joins the processes into one job; ``mesh`` holds the
mesh, the data- and tensor-parallel train steps, their placement helpers,
``model_shardings``, ``gathered`` and ``shard_render``.  A run over N cards
of one host is ``torchrun --nproc_per_node=N <script>``, whose script
calls ``init_distributed()`` with no arguments and ``make_mesh(shape=(dp,
tp))`` with dp * tp = N.
"""

import os

import torch
import torch.distributed as dist

from nerftex_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    gathered,
    make_mesh,
    make_parallel_fused_train_step,
    make_parallel_train_step,
    model_shardings,
    replicated,
    shard_render,
)

# torchrun's variables; any of them in the environment asks for a job.
_LAUNCHER_ENV = ("MASTER_ADDR", "RANK", "WORLD_SIZE")


def init_distributed(coordinator_address=None, num_processes=None, process_id=None,
                     backend=None, device=None) -> bool:
    """Join this process to a torch.distributed job; returns whether it did.

    With no arguments and none of torchrun's variables (MASTER_ADDR, RANK,
    WORLD_SIZE) in the environment this is a single process: nothing
    happens and it returns False, as the JAX package's does.  Otherwise
    the process group meets at ``coordinator_address`` ("host:port",
    default MASTER_ADDR:MASTER_PORT) with ``num_processes`` processes
    (default WORLD_SIZE), this one of rank ``process_id`` (default RANK).

    The backend is NCCL, each process pinned to its card,
    ``cuda:<LOCAL_RANK>`` (default: the rank) or ``device``, so that
    utils.util.resolve_device() names that card.  gloo is used only when
    asked for, by ``backend="gloo"`` or ``device="cpu"``; a gloo process
    given a CUDA ``device`` with an index is pinned to it.  Nothing falls
    back: without CUDA or NCCL, asking for NCCL raises."""
    env = os.environ
    if coordinator_address is None and not any(k in env for k in _LAUNCHER_ENV):
        return False
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
    rank = int(env["RANK"] if process_id is None else process_id)
    if backend is None:
        backend = "gloo" if device is not None and torch.device(device).type == "cpu" else "nccl"
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the NCCL backend needs a CUDA card; pass backend='gloo' or "
                               "device='cpu' to run on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this PyTorch was built without NCCL")
        card = torch.device("cuda") if device is None else torch.device(device)
        if card.index is None:
            card = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    elif device is not None and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=coordinator_address, world_size=world,
                            rank=rank, **kwargs)
    return True


__all__ = ["Mesh", "Sharding", "batch_sharding", "gathered", "init_distributed", "make_mesh",
           "make_parallel_fused_train_step", "make_parallel_train_step", "model_shardings",
           "replicated", "shard_render"]
