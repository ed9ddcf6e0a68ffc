"""frame_ms.p90: the 90th percentile over every frame of the window of the
wall ms from the first IMU sample after the previous frame until
``add_image`` of the frame returned (numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    x = ctx["window"].get("frame_ms")
    return float(np.percentile(np.asarray(x), 90)) if x else None
