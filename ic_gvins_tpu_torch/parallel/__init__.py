"""Sharded and batched solves (``parallel/``) on one card or across
``torch.distributed`` ranks.

The JAX package runs these on a device mesh under ``shard_map``: each
device holds one shard of an axis (landmarks ``"lm"``, node chunks
``"nodes"``, sequences ``"dp"``) and ``psum`` / ``pmax`` reduce across the
devices and, under ``jax.distributed``, across processes. Here one process
is one rank, and every rank runs the same program. A ``Mesh`` holds the
global shard count of each axis; each rank holds ``mesh.shape[axis] /
world`` of them as a local leading tensor axis (rank r the shards
``[r * local, (r + 1) * local)``), as JAX's 2 processes x 4 devices do.
``psum`` / ``pmax`` reduce in JAX's order: within each shard first, then
over the rank's local shards, then one ``all_reduce`` across the ranks.
Without a process group (one rank) they are a sum / max over the local
axis and nothing else.

The collectives are ``all_reduce`` only, which the ``gloo`` backend takes
on CUDA tensors as ``nccl`` does, so one code path serves both. Tuples of
reductions are packed into one flat buffer (``psum_packed``), as JAX
reduces a tuple in one ``psum``; fields split over the ranks are gathered
by one ``all_reduce`` of bytes (``assemble``).

Nothing here imports the solver, so the solver can import the
collectives.
"""

import datetime
import time

import torch
import torch.distributed as dist

from ..device import resolve_device


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout: float = 60.0):
    """Join this process to the default process group as ``rank`` of
    ``world_size`` (``init_method`` e.g. ``tcp://127.0.0.1:PORT``). The
    caller names the backend (``"nccl"``: one card per rank; ``"gloo"``);
    nothing is picked here. ``timeout`` (s) bounds every collective, so
    ranks that part fail instead of waiting for ever. Returns the group."""
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def shutdown_distributed():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(world: int, target, args=(), timeout: float = 400.0, meanwhile=None):
    """Run ``target(rank, world, init, *args)`` in ``world`` processes
    started with the ``spawn`` method (the caller may have initialized
    CUDA), ``init`` a rendezvous on a free local port for
    ``init_distributed``; run ``meanwhile()`` here while they run. Kills
    them all when they have not finished in ``timeout`` s, and raises
    then or when one failed. Returns what ``meanwhile`` returned."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    ref = None
    try:
        if meanwhile is not None:
            ref = meanwhile()
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
    if hung:
        raise RuntimeError(f"{len(hung)} of {world} ranks did not end within {timeout:.0f} s")
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks of a {world}-rank run failed: exit codes {codes}")
    return ref


class Mesh:
    """Global shard counts by axis name (``Mesh({"lm": 8})``), this rank
    and the world: the stand-in for ``jax.sharding.Mesh``.
    ``mesh.shape[name]`` is the global number of shards of an axis and
    ``mesh.local(name)`` the number this rank holds. ``device`` is this
    rank's device (``cuda:0`` when it is ``None``); ``group`` the process
    group, by default the default group when this process has joined one,
    else none (one rank). ``mesh.all_reduces`` counts the collectives
    made through the mesh."""

    def __init__(self, shape: dict, device=None, group=None):
        for name, n in shape.items():
            if int(n) < 1:
                raise ValueError(f"mesh axis {name!r} needs at least one shard, got {n}")
        self.shape = {name: int(n) for name, n in shape.items()}
        self.device = resolve_device(device)
        if group is None and dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        for name, n in self.shape.items():
            if n % self.world != 0:
                raise ValueError(f"mesh axis {name!r}: {n} shards do not divide over "
                                 f"{self.world} ranks")
        self.all_reduces = 0

    @property
    def distributed(self) -> bool:
        """More than one rank: the reductions cross processes."""
        return self.world > 1

    def local(self, axis: str) -> int:
        """Shards of ``axis`` this rank holds."""
        return self.shape[axis] // self.world

    def first(self, axis: str) -> int:
        """Global index of this rank's first shard of ``axis``."""
        return self.rank * self.local(axis)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks in place (``op`` "sum" or "max");
        ``x`` itself with one rank."""
        if self.distributed:
            ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
            dist.all_reduce(x, op=ops[op], group=self.group)
            self.all_reduces += 1
        return x

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device}, rank={self.rank}, world={self.world})"


def psum(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Sum over the leading local shard axis, then over the ranks (JAX
    ``lax.psum``)."""
    s = x.sum(0)
    return s if mesh is None else mesh.all_reduce(s, "sum")


def pmax(x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Max over the leading local shard axis, then over the ranks (JAX
    ``lax.pmax``)."""
    s = x.amax(0)
    return s if mesh is None else mesh.all_reduce(s, "max")


def psum_packed(xs, mesh: Mesh | None = None) -> list:
    """``psum`` of several tensors of one dtype with one collective: each
    summed over its leading local shard axis, the sums packed into one flat
    buffer and reduced over the ranks at once (JAX's ``psum`` of a
    tuple)."""
    sums = [x.sum(0) for x in xs]
    if mesh is None or not mesh.distributed:
        return sums
    flat = mesh.all_reduce(torch.cat([s.reshape(-1) for s in sums]), "sum")
    out, at = [], 0
    for s in sums:
        out.append(flat[at:at + s.numel()].reshape(s.shape))
        at += s.numel()
    return out


def psum_rank0(x: torch.Tensor, rep: torch.Tensor, mesh: Mesh, also_max=None):
    """``psum(x) + rep`` for a 0-dim ``x`` per shard and a replicated
    ``rep``, with one collective in which only rank 0 adds ``rep``: every
    rank gets bit for bit the same value, though the ranks' own copies of
    ``rep`` need not agree to the bit. Decisions of the
    LM read such values. With ``also_max`` (a 0-dim tensor of this rank)
    the same collective also gives its max over the ranks, each rank
    writing it into its own slot of zeros (``b + 0 == b``): returns (sum,
    max)."""
    s = x.sum(0)
    if mesh.rank == 0:
        s = s + rep
    if also_max is None:
        return mesh.all_reduce(s, "sum")
    slots = s.new_zeros(mesh.world)
    slots[mesh.rank] = also_max
    buf = mesh.all_reduce(torch.cat([s.reshape(1), slots]), "sum")
    return buf[0], buf[1:].max()


_ALIGN = 8  # bytes: every part starts aligned for its dtype


def assemble(parts, mesh: Mesh) -> list:
    """Whole tensors from the ranks' parts with one ``all_reduce`` of
    bytes. Each part is ``(x, start, total)``: ``x`` holds the rows
    ``[start, start + len(x))`` of a tensor of ``total`` rows, the other
    rows lie on other ranks; ``start=None`` marks a replicated ``x``, of
    which rank 0's copy is taken. Every rank writes its bytes into zeros
    of the whole size and the bytes are summed: ``b + 0 == b``, so the
    result is exact and the same on every rank. With one rank the parts
    come back as they are."""
    if not mesh.distributed:
        return [x for x, _, _ in parts]
    layout, size = [], 0
    for x, start, total in parts:
        shape = x.shape if start is None else (total,) + tuple(x.shape[1:])
        n = torch.Size(shape).numel() * x.element_size()
        layout.append((shape, x.dtype, size, n))
        size += -(-n // _ALIGN) * _ALIGN
    buf = torch.zeros(size, dtype=torch.uint8, device=parts[0][0].device)
    for (x, start, _), (_, _, at, n) in zip(parts, layout):
        if start is None and mesh.rank != 0:
            continue
        row = x.shape[1:].numel() * x.element_size() if start is not None and x.dim() else 0
        off = at + (start * row if start is not None else 0)
        src = x.contiguous().reshape(-1).view(torch.uint8)
        buf[off:off + src.numel()] = src
    mesh.all_reduce(buf, "sum")
    return [buf[at:at + n].view(dtype).reshape(shape) for shape, dtype, at, n in layout]
