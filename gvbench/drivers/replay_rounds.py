"""The closed-loop replay of ``replay.py`` with the estimator's rounds as
the window's calls, one window each: ``windows_per_s`` reads the rounds
completed in the window over its wall.

The run's notes add ``dead_cleared``: the observations and landmark slots
that the estimator cleared because their point died with a marginalized
anchor, over the whole run, where the program counts them.
"""

import torch

from . import replay


def run(spec, cell, config, traffic, seed, seconds, trace, device, t_start, dtype=torch.float64):
    from ic_gvins_tpu_torch.engine import pipeline

    counters = []
    real = pipeline.Pipeline

    class Counted(real):
        """The program's ``Pipeline``, whose estimator's counter the run keeps."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            counters.append(getattr(self.est, "_dead_cleared", None))

    pipeline.Pipeline = Counted
    try:
        rec = replay.run(spec, cell, config, traffic, seed, seconds, trace, device, t_start,
                         dtype=dtype)
    finally:
        pipeline.Pipeline = real
    window = rec["window"]
    window["batch"] = 1
    window["calls"] = len(window["stage_ms"].get("optimize", []))
    if counters and counters[0] is not None:
        rec["notes"]["dead_cleared"] = dict(counters[0])
    return rec
