"""The comparison's controls: the program, or the reference put in its
place, one precision below what the configuration states. A control run
has to come out not correct.

``f32``: the program's own float32 engine mode in place of the float64
the configurations state (``Estimator`` and ``Pipeline`` with
``dtype=torch.float32``; the batch's windows cast to float32).
``klt-bf16``: the tracker's images are float32; in the program's place the
frozen plain tracker tracks on the pyramids held in bfloat16.

``assembly-fault`` is no control but a fault planted in the program's
host path, for ``assembly_err``'s upper reading: of each frame's features
handed to the estimator, the first half get their neighbour's
observation (a gather one place off), so their landmark slots mix points.
"""

import torch

from .reference.vision import klt

DTYPES = {"f64": torch.float64, "f32": torch.float32, "klt-bf16": torch.float64,
          "assembly-fault": torch.float64}


def install(control: str, undo: list):
    """Put ``control`` in place; ``undo`` receives what restores it."""
    if control == "assembly-fault":
        _install_assembly_fault(undo)
    if control != "klt-bf16":
        return
    from ic_gvins_tpu_torch.vision import klt_cuda

    real = klt_cuda.lk_track_bidirectional

    def tracked_in_bf16(pyr0, pyr1, pts0, pts1_init, valid, fb_thresh=0.5):
        bf = lambda pyr: tuple(x.to(torch.bfloat16).to(torch.float32) for x in pyr)  # noqa: E731
        return klt.lk_track_bidirectional(bf(pyr0), bf(pyr1), pts0, pts1_init, valid, fb_thresh)

    klt_cuda.lk_track_bidirectional = tracked_in_bf16
    undo.append(lambda: setattr(klt_cuda, "lk_track_bidirectional", real))


def _install_assembly_fault(undo: list):
    import numpy as np
    from ic_gvins_tpu_torch.engine.estimator import Estimator

    real = Estimator.add_frame_observations

    def misgathered(self, t, ids, uv, vel=None, force_kf=None):
        uv = np.array(uv, np.float64)
        q = len(uv) // 2
        uv[:q] = np.roll(uv[:q], 1, axis=0)
        return real(self, t, ids, uv, vel, force_kf=force_kf)

    Estimator.add_frame_observations = misgathered
    undo.append(lambda: setattr(Estimator, "add_frame_observations", real))
