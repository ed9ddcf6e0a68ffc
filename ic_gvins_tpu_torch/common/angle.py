"""Degree/radian helpers (parity with ``ic_gvins/common/angle.h:29-30``)."""

import math

D2R = math.pi / 180.0
R2D = 180.0 / math.pi


def deg2rad(x):
    return x * D2R


def rad2deg(x):
    return x * R2D
