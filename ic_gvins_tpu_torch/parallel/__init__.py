"""Sharded and batched solves (``parallel/``) on one card or across
``torch.distributed`` ranks, and the process group they run in.

The mesh and its collectives live one layer down, in ``mesh.py``, which
the solver imports too; they are re-exported here. The packages import in
one direction: ``engine`` -> ``parallel`` -> ``solver`` -> ``mesh`` /
``device``.
"""

import datetime
import time

import torch.distributed as dist

from ..mesh import Mesh, assemble, pmax, psum, psum_packed, psum_rank0  # noqa: F401


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
