"""LM loops and the IMU preintegration replayed from CUDA graphs
(``solver/graphs.py``).

A loop is written as chains: pure functions of a state dict (the inputs
and the loop's device tensors) that return the entries they change. A run
takes each chain's result as the new state, eagerly or from a CUDA graph.

On a CUDA device each chain is captured once per key (the inputs' pytree
structure, each tensor's shape, dtype and device, every other leaf's
value; the chain's name, which carries its flags and constants) and
replayed: one graph launch in place of the ~1000-2000 kernel launches of
an LM iteration. A key runs eagerly the first time it comes and is
captured the second, so one-off shapes pay no capture. Strides are not
part of the key: ``copy_`` into the static buffers takes any layout.
Elsewhere every chain runs eagerly.

There are two sets of chains, each user keeping its own ``Graphs`` (keys,
plans and counts): ``solver/lm.py``'s LM loop, run by ``solver/lm.py`` for
the single window and by ``parallel/multi_seq.py`` for the batch, and
``ins/preintegration.py``'s one-chain preintegration.
"""

import torch
import torch.utils._pytree as pytree


class Graphs:
    """One user's keys seen, captured plans and counts of chains captured,
    replayed from a graph and run eagerly (an LM iteration is one chain)."""

    def __init__(self):
        self.counts = dict(captured=0, replayed=0, eager=0)
        self.seen: set = set()
        self.plans: dict = {}

    def graph_counts(self) -> dict:
        return dict(self.counts)

    def reset(self):
        """Forget every key and captured graph, and zero the counts."""
        self.seen.clear()
        self.plans.clear()
        self.counts.update(captured=0, replayed=0, eager=0)

    def runner(self, state: dict, device):
        """The run of ``state``'s chains: eager off a CUDA device and for a
        key's first call, then from the key's graphs."""
        if device.type != "cuda":
            return Eager(state, self.counts)
        leaves, spec = pytree.tree_flatten(state)
        key = (spec, tuple((tuple(x.shape), x.dtype, x.device) if torch.is_tensor(x) else x
                           for x in leaves))
        if key not in self.seen:
            self.seen.add(key)
            return Eager(state, self.counts)
        if key not in self.plans:
            self.plans[key] = Graphed(state, device, self.counts)
        return self.plans[key].load(state)


class Eager:
    """Runs each chain as it comes; its result becomes the state."""

    def __init__(self, state: dict, counts: dict):
        self.state = state
        self.counts = counts

    def run(self, name, chain):
        self.counts["eager"] += 1
        self.state.update(chain(self.state))

    def take(self, *keys):
        return tuple(self.state[k] for k in keys)


class Graphed:
    """One key's state in static buffers and its chains as CUDA graphs,
    which write their results back into the same buffers. The graphs share
    one memory pool: they never run at once."""

    def __init__(self, state: dict, device, counts: dict):
        self.device = device
        self.counts = counts
        self.state = pytree.tree_map(
            lambda x: torch.empty_like(x) if torch.is_tensor(x) else x, state)
        self.graphs = {}
        self.pool = torch.cuda.graph_pool_handle()

    def load(self, state: dict):
        for k, v in state.items():
            copy_into(self.state[k], v)
        return self

    def run(self, name, chain):
        graph = self.graphs.get(name)
        with torch.cuda.device(self.device):
            if graph is None:
                graph = self.graphs[name] = self._capture(chain)
            graph.replay()
        self.counts["replayed"] += 1

    def _capture(self, chain):
        # warm up on a side stream (lazy library set-up; the shapes of new
        # state entries), dropping the result so that the state stays where
        # the first replay starts from
        here, side = torch.cuda.current_stream(), torch.cuda.Stream()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            out = chain(self.state)
        here.wait_stream(side)
        for k, v in out.items():
            if k not in self.state:
                self.state[k] = pytree.tree_map(torch.empty_like, v)
        del out
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            for k, v in chain(self.state).items():
                copy_into(self.state[k], v)
        self.counts["captured"] += 1
        return graph

    def take(self, *keys):
        """Fresh copies: the next call overwrites the buffers."""
        return tuple(pytree.tree_map(torch.clone, self.state[k]) for k in keys)


def copy_into(dst, src):
    pytree.tree_map(lambda d, s: d.copy_(s) if torch.is_tensor(d) else d, dst, src)
