"""Carry state between the JAX package and the port as numpy arrays.

``to_torch(cls, tree, device)`` builds one of the port's NamedTuples
(``Window``, ``Prior``, ``SolverConfig``, ``IntegrationParams``,
``NavState``, ``Camera``, ``PreintData``, ``ImuSeq``) from a mapping or
NamedTuple of numpy arrays with the same field names, nested the same way;
``to_numpy(tree)`` turns a NamedTuple back into nested dicts of numpy
arrays. Nothing here imports jax: a JAX state goes through ``to_numpy``
(which only calls ``np.asarray`` on its leaves) or the caller's own
``{k: np.asarray(v) for k, v in win._asdict().items()}``.

Both keep the arrays' dtypes: a JAX float32 state (x64 off) becomes port
float32 tensors, not widened. ``cast(tree, dtype)`` changes the floating
leaves of a port state, for the engine's float32 mode.
"""

import numpy as np
import torch

from .data.types import NavState
from .device import resolve_device
from .ins.preintegration import PreintData
from .solver.window import Prior, Window

# NamedTuple-valued fields of each container
_NESTED = {
    Window: {"nodes": NavState, "preint": PreintData},
    PreintData: {"end_state": NavState},
    Prior: {"lin_nodes": NavState},
}


def _field(tree, name):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def to_torch(cls, tree, device=None):
    """Build ``cls`` from numpy data on ``device`` (the card when it is
    ``None``); ints stay ints where the container declares them
    (``Camera.width``/``height``) and ``None`` stays ``None``."""
    device = resolve_device(device)
    nested = _NESTED.get(cls, {})
    ints = {k for k, t in cls.__annotations__.items() if t is int}
    kw = {}
    for name in cls._fields:
        if isinstance(tree, dict) and name not in tree and name in cls._field_defaults:
            continue
        v = _field(tree, name)
        if name in nested:
            kw[name] = to_torch(nested[name], v, device)
        elif v is None:
            kw[name] = None
        elif name in ints:
            kw[name] = int(v)
        else:
            kw[name] = torch.as_tensor(np.array(v), device=device)
    extra = set(tree) - set(cls._fields) if isinstance(tree, dict) else set()
    if extra:
        raise ValueError(f"{cls.__name__} has no fields {sorted(extra)}")
    return cls(**kw)


def cast(tree, dtype):
    """A NamedTuple of the port (nested) with its floating tensors in
    ``dtype``; integer and bool tensors, ints and ``None`` unchanged."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast(v, dtype) for v in tree))
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def to_numpy(tree):
    """Nested dicts of numpy arrays from a NamedTuple of the port (torch
    tensors) or of any package whose leaves support ``np.asarray``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: to_numpy(v) for k, v in tree._asdict().items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if tree is None or isinstance(tree, (int, float, bool)):
        return tree
    return np.asarray(tree)


def flatten(tree, prefix=""):
    """Nested dicts -> one flat dict with '/'-joined keys (for .npz)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def unflatten(flat, prefix=""):
    """The nested dict under ``prefix`` of a flat '/'-keyed mapping."""
    out = {}
    for key in flat:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = flat[key]
    return out
