"""INS mechanization pieces (``ins/mechanization.py``): bias compensation
and two-sample coning/sculling, as used by the preintegration."""

from ..common.rotation import cross


def compensate_bias(dtheta, dvel, dt, bg, ba):
    """Remove bias increments: dtheta - dt*bg, dvel - dt*ba."""
    return dtheta - dt[..., None] * bg, dvel - dt[..., None] * ba


def coning_sculling(dtheta_pre, dvel_pre, dtheta_cur, dvel_cur):
    """Two-sample coning/sculling corrected increments (dvfb, dtheta)."""
    dvfb = (
        dvel_cur
        + 0.5 * cross(dtheta_cur, dvel_cur)
        + (1.0 / 12.0)
        * (cross(dtheta_pre, dvel_cur) + cross(dvel_pre, dtheta_cur))
    )
    dtheta = dtheta_cur + (1.0 / 12.0) * cross(dtheta_pre, dtheta_cur)
    return dvfb, dtheta
