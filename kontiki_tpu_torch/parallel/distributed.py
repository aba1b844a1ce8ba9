"""Multi-host scaffolding (counterpart of
``kontiki_tpu.parallel.distributed``): join a ``torch.distributed`` job and
build the mesh over all of its processes.

Each process of a job runs the same program; ``initialize()`` joins the
process group and ``global_mesh()`` returns this process's ``Mesh`` over
all of them, on which every sharded solver of ``kontiki_tpu_torch.parallel``
runs unchanged. A single process (no job) skips initialization and gets
the one-shard mesh, so the same code runs everywhere.

Environment, as in the JAX package:
    KONTIKI_DISTRIBUTED=1           opt in to joining a job
    KONTIKI_COORDINATOR=host:port   the rendezvous address (else torchrun's
                                    MASTER_ADDR and MASTER_PORT)
    KONTIKI_NUM_PROCESSES, KONTIKI_PROCESS_ID   (else torchrun's WORLD_SIZE
                                    and RANK)
A job started by torchrun (``RANK`` and ``WORLD_SIZE`` set) joins without
``KONTIKI_DISTRIBUTED``. The backend is NCCL where each process has a
card of its own (``LOCAL_RANK`` picks it), gloo otherwise.
"""
import os

import torch
import torch.distributed as dist

from .mesh import Mesh

__all__ = ["initialize", "global_mesh", "is_multiprocess", "process_local_rows"]

_initialized = False


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _local_device(device):
    """This process's device: ``device`` if named, else its card
    (``LOCAL_RANK`` over the host's cards), else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count())
    return torch.device("cpu")


def initialize(device=None):
    """Join the job when ``KONTIKI_DISTRIBUTED=1`` or torchrun's variables
    ask for one. Safe to call more than once and in a single process (a
    no-op there). Returns True when running multi-process."""
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return is_multiprocess()
    env = os.environ
    opted = env.get("KONTIKI_DISTRIBUTED", "0") in ("1", "true")
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    if not (opted or torchrun):
        _initialized = True
        return False
    world = _env_int("KONTIKI_NUM_PROCESSES", "WORLD_SIZE")
    rank = _env_int("KONTIKI_PROCESS_ID", "RANK")
    address = env.get("KONTIKI_COORDINATOR") or (
        f"{env.get('MASTER_ADDR', 'localhost')}:{env.get('MASTER_PORT', '29500')}")
    dev = _local_device(device)
    local = _env_int("LOCAL_WORLD_SIZE") or 1
    backend = "nccl" if dev.type == "cuda" and local <= torch.cuda.device_count() else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world,
                            rank=rank)
    _initialized = True
    return True


def is_multiprocess():
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(device=None):
    """The mesh over every process of the job (after ``initialize()``); a
    single process gets the one-shard mesh on ``device`` (None: the CUDA
    card)."""
    initialize(device)
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.group.WORLD, _local_device(device))
    from ..config import resolve_device

    return Mesh(device=resolve_device(device))


def process_local_rows(n_rows):
    """The ``[start, stop)`` rows this process should materialize when each
    process builds its own part of a problem (e.g. loads its own sensor log
    shard): an even split in process order; all rows in a single
    process."""
    if dist.is_available() and dist.is_initialized():
        p, n = dist.get_rank(), dist.get_world_size()
    else:
        p, n = 0, 1
    per = (n_rows + n - 1) // n
    return min(p * per, n_rows), min((p + 1) * per, n_rows)
