"""Sharded and batched solves (``parallel/``) on one card.

The JAX package runs these on a device mesh under ``shard_map``: each
device holds one shard of an axis (landmarks ``"lm"``, node chunks
``"nodes"``, sequences ``"dp"``) and ``psum`` / ``pmax`` reduce across the
devices. Here a shard is a slice of a leading tensor axis on one device,
and the collectives are a sum / max over that axis. The order of a
reduction stays the JAX one: within each shard first, then across the
shards. A port to several cards replaces ``psum`` and ``pmax`` by
``torch.distributed.all_reduce``.

Nothing here imports the solver, so the solver can import the
collectives.
"""

import torch

from ..device import resolve_device


class Mesh:
    """Shard counts by axis name (``Mesh({"lm": 8})``) on one device: the
    stand-in for ``jax.sharding.Mesh``. ``mesh.shape[name]`` is the number
    of shards of that axis."""

    def __init__(self, shape: dict, device=None):
        for name, n in shape.items():
            if int(n) < 1:
                raise ValueError(f"mesh axis {name!r} needs at least one shard, got {n}")
        self.shape = {name: int(n) for name, n in shape.items()}
        self.device = resolve_device(device)

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.device})"


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading shard axis (JAX ``lax.psum``)."""
    return x.sum(0)


def pmax(x: torch.Tensor) -> torch.Tensor:
    """Max over the leading shard axis (JAX ``lax.pmax``)."""
    return x.amax(0)
