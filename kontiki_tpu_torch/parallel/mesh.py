"""A process-group mesh over the measurement axis (counterpart of the JAX
package's ``jax.sharding.Mesh`` of ``default_mesh``) and the collectives
its sharded code calls inside ``shard_map``: ``psum``, ``pmax``,
``ppermute`` and ``axis_index``.

One process is one shard. A ``Mesh`` holds a ``torch.distributed`` process
group, this rank's index, the shard count and the rank's ``torch.device``.
A ``Mesh()`` without a group is one shard in this process: every
collective is then an identity (``ppermute``'s only pair is the self pair)
and the sharded code is the one-device code.

- ``psum(x)`` and ``pmax(x)`` are one ``dist.all_reduce`` of ``x`` (a
  tensor or a list of tensors of one dtype, packed into one buffer). A ring
  all-reduce (gloo's, NCCL's) sends every rank the same reduced chunks, so
  every rank reads the same bits: the LM loop's accept test reads these
  sums on every rank, and ranks that decided differently would deadlock.
- ``ppermute(x, pairs)`` has ``jax.lax.ppermute``'s semantics: a rank
  receives the value of the rank paired to it, a rank that receives from
  none gets zeros, a pair from a rank to itself is a copy. It is one
  ``dist.batch_isend_irecv``. The backend picks the transport: NCCL sends
  device tensors as they are; gloo has no CUDA point-to-point, so a CUDA
  tensor goes through host buffers, copied there and back explicitly.
- ``allgather(x)`` concatenates every rank's equal-shaped ``x`` along the
  first axis: each rank places its block in zeros and one ``psum`` adds
  the disjoint blocks (exact: a value plus zeros is the value).
"""
import torch
import torch.distributed as dist

__all__ = ["MEASUREMENT_AXIS", "Mesh"]

#: the mesh axis name, kept for parity with the JAX package
MEASUREMENT_AXIS = "m"


def _pack(x):
    """(flat buffer, shapes, was_a_list) of a tensor or a list of tensors."""
    many = isinstance(x, (list, tuple))
    xs = list(x) if many else [x]
    dtypes = {t.dtype for t in xs}
    if len(dtypes) != 1:
        raise TypeError(f"a packed collective takes tensors of one dtype, got {dtypes}")
    flat = torch.cat([t.reshape(-1) for t in xs]) if xs else torch.zeros(0)
    return flat, [t.shape for t in xs], many


def _unpack(flat, shapes, many):
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    out = [p.view(s) for p, s in zip(flat.split(sizes), shapes)]
    return out if many else out[0]


class Mesh:
    """One rank of a 1-D mesh of ``size`` shards over a process group.

    ``Mesh()`` (no group) is the one-shard mesh in this process; ``Mesh(group,
    device)`` is this rank of ``group`` with its tensors on ``device``."""

    def __init__(self, group=None, device="cpu"):
        self.group = group
        self.device = torch.device(device)
        if group is None:
            self.rank, self.size, self.backend = 0, 1, None
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.backend = str(dist.get_backend(group))

    @property
    def transport(self):
        """How ``ppermute`` moves this mesh's tensors."""
        if self.group is None:
            return "in-process copy"
        if self.backend == "nccl":
            return "nccl, device to device"
        if self.device.type == "cuda":
            return "gloo through host buffers"
        return "gloo"

    def axis_index(self):
        """This shard's index on the axis (``jax.lax.axis_index``)."""
        return self.rank

    def psum(self, x):
        """Sum of ``x`` over the shards, on every shard (``jax.lax.psum``)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        """Elementwise maximum of ``x`` over the shards (``jax.lax.pmax``)."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def _reduce(self, x, op):
        if self.group is None:
            return x
        flat, shapes, many = _pack(x)  # a new buffer: all_reduce writes in place
        dist.all_reduce(flat, op=op, group=self.group)
        return _unpack(flat, shapes, many)

    def _global(self, r):
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def ppermute(self, x, pairs):
        """``jax.lax.ppermute(x, axis, pairs)``: ``pairs`` lists ``(source,
        destination)`` shard indices, each shard at most once on either
        side; this shard gets its source's ``x``, or zeros."""
        flat, shapes, many = _pack(x)
        sources = [s for s, d in pairs if d == self.rank]
        dests = [d for s, d in pairs if s == self.rank]
        if len(sources) > 1 or len(dests) > 1:
            raise ValueError(f"shard {self.rank} appears twice on one side of {pairs}")
        src = sources[0] if sources else None
        dst = dests[0] if dests else None
        out = flat if src == self.rank else torch.zeros_like(flat)
        send = dst is not None and dst != self.rank
        recv = src is not None and src != self.rank
        if send or recv:
            if self.group is None:
                raise ValueError(f"a one-shard mesh has no shard {src if recv else dst}")
            staged = self.backend != "nccl" and flat.is_cuda
            buf = flat.cpu() if staged else flat
            got = torch.empty_like(buf)
            ops = []
            if send:
                ops.append(dist.P2POp(dist.isend, buf, self._global(dst), self.group))
            if recv:
                ops.append(dist.P2POp(dist.irecv, got, self._global(src), self.group))
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            if recv:
                out = got.to(flat.device) if staged else got
        return _unpack(out, shapes, many)

    def allgather(self, x):
        """Every shard's ``x`` (a tensor or a list; equal shapes on every
        shard) concatenated along the first axis in shard order."""
        if self.group is None:
            return x
        many = isinstance(x, (list, tuple))
        placed = []
        for t in (x if many else [x]):
            k = t.shape[0]
            z = t.new_zeros((self.size * k, *t.shape[1:]))
            z[self.rank * k:(self.rank + 1) * k] = t
            placed.append(z)
        return self.psum(placed if many else placed[0])

    def barrier(self):
        """Wait until every shard has reached this call (one ``psum``)."""
        if self.group is not None:
            self.psum(torch.zeros(1, device=self.device))
