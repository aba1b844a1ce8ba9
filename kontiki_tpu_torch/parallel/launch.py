"""Run one function on ``n`` ranks of a single-host process group (the
counterpart of the JAX package's ``default_mesh(n_devices=n)``, where one
process drives ``n`` devices; here each shard is a process).

``run_spmd(fn, n, device, *args)`` spawns ``n`` processes (the spawn
context), joins them in a ``torch.distributed`` group through a ``file://``
rendezvous in a temporary directory (a TCP port could collide between
concurrent runs; a file cannot), and calls ``fn(mesh, *args)`` on each with
its ``parallel.mesh.Mesh``. Each rank runs ``torch.set_num_threads(1)``.
It returns every rank's result, in rank order, with tensors moved to the
host.

The backend: NCCL where each rank has a CUDA card of its own, gloo where
ranks share a card, and always gloo on the CPU. ``device="cuda"`` puts rank
r on card ``r % torch.cuda.device_count()``; ``"cuda:0"`` puts every rank
on that card; no rank moves to the CPU when a card was asked for.

A rank that raises makes ``run_spmd`` raise with that rank's traceback; a
rank that exits with another code than 0 makes it raise too. The group's
``timeout`` bounds every collective, so a rank whose peers are gone raises
instead of waiting forever. Every process is ended before ``run_spmd``
returns or raises.

``fn`` and ``args`` must pickle: a module-level function of a module that
the ranks can import.
"""
import datetime
import os
import pickle
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import Mesh

__all__ = ["run_spmd", "rank_device", "backend_for"]


def rank_device(device, rank):
    """The ``torch.device`` of ``rank``: a bare ``"cuda"`` spreads ranks over
    the cards; a named card or the CPU is every rank's."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    return dev


def backend_for(device, n):
    """NCCL when each of ``n`` ranks has a card of its own, else gloo."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    cards = 1 if dev.index is not None else torch.cuda.device_count()
    return "nccl" if n <= cards else "gloo"


def _to_host(x):
    if torch.is_tensor(x):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, n, backend, device, init_file, timeout, fn, args, results):
    try:
        torch.set_num_threads(1)
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout))
        out = fn(Mesh(dist.group.WORLD, dev), *args)
        # pickled here by the pickle module: the queue's own pickler would
        # pass tensors through shared memory that dies with this process
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_spmd(fn, n, device, *args, timeout=600.0):
    """``[fn(mesh, *args) for each of n ranks]`` on a fresh process group of
    ``backend_for(device, n)``; ``timeout`` (seconds) bounds each
    collective."""
    backend = backend_for(device, n)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out = {}
    with tempfile.TemporaryDirectory(prefix="kontiki_spmd_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, name=f"kontiki-rank-{r}",
                             args=(r, n, backend, str(device), init_file, timeout, fn, args,
                                   results))
                 for r in range(n)]
        try:
            for p in procs:
                p.start()
            while len(out) < n:
                try:
                    rank, ok, payload = results.get(timeout=0.1)
                except queue_mod.Empty:
                    _check_exits(procs, out, results)
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{payload}")
                out[rank] = pickle.loads(payload)
            for r, p in enumerate(procs):
                p.join(timeout)
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} of {n} exited with code {p.exitcode}")
        finally:
            _end(procs)
    return [out[r] for r in range(n)]


def _check_exits(procs, out, results):
    """Raise for a rank that ended without a result (after a last look at
    the queue, which may still hold its message)."""
    for r, p in enumerate(procs):
        if r not in out and p.exitcode is not None:
            deadline = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                try:
                    rank, ok, payload = results.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {len(procs)} failed:\n{payload}")
                out[rank] = pickle.loads(payload)
                if rank == r:
                    return
            raise RuntimeError(f"rank {r} of {len(procs)} exited with code {p.exitcode} "
                               "without a result")


def _end(procs):
    procs = [p for p in procs if p.pid is not None]  # started
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5.0)
        if p.is_alive():
            p.kill()
            p.join()
