# The one-process form of ic_gvins_tpu_torch/parallel/__init__.py at commit
# ab7fbd6: the reductions the frozen solver calls, for ``mesh=None`` only.
# The reference runs on one device and never shards.
"""Reductions over the leading shard axis for the frozen solver (no ranks)."""

import torch


def _no_mesh(mesh):
    if mesh is not None:
        raise ValueError("the reference runs unsharded: mesh must be None")


def psum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    _no_mesh(mesh)
    return x.sum(0)


def pmax(x: torch.Tensor, mesh=None) -> torch.Tensor:
    _no_mesh(mesh)
    return x.amax(0)


def psum_packed(xs, mesh=None) -> list:
    _no_mesh(mesh)
    return [x.sum(0) for x in xs]


def psum_rank0(x, rep, mesh, also_max=None):
    raise ValueError("the reference runs unsharded: no cross-rank sums")
