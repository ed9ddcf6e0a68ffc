"""WGS84 Earth model (``common/earth.py``): Somigliana gravity, curvature
radii, n-frame DCM/quaternion from geodetic coordinates, blh <-> ECEF,
local-NED <-> geodetic conversions for points and poses, Earth rate and
transport rate.

Every function works over the trailing axes of float64 tensors. The
n-frame is North-East-Down anchored at a station origin; "blh" is
[latitude (rad), longitude (rad), ellipsoidal height (m)]. ``ecef_to_blh``
runs the JAX package's fixed 5 rounds of its fixed-point iteration.
"""

import math

import torch

from .rotation import mv

WGS84_WIE = 7.2921151467e-5  # Earth rotation rate (rad/s)
WGS84_F = 0.0033528106647474805  # flattening
WGS84_RA = 6378137.0  # semi-major axis (m)
WGS84_RB = 6356752.3142451793  # semi-minor axis (m)
WGS84_GM0 = 398600441800000.0  # gravitational constant
WGS84_E1 = 0.0066943799901413156  # first eccentricity squared
WGS84_E2 = 0.0067394967422764341  # second eccentricity squared


def gravity(blh: torch.Tensor) -> torch.Tensor:
    """Somigliana normal gravity with height correction, (..., 3) -> (...)."""
    s2 = torch.sin(blh[..., 0]) ** 2
    h = blh[..., 2]
    return (
        9.7803267715 * (1 + 0.0052790414 * s2 + 0.0000232718 * s2 * s2)
        + h * (0.0000000043977311 * s2 - 0.0000030876910891)
        + 0.0000000000007211 * h * h
    )


def gravity_ned(blh: torch.Tensor) -> torch.Tensor:
    """Gravity vector in the NED n-frame: [0, 0, g]."""
    g = gravity(blh)
    z = torch.zeros_like(g)
    return torch.stack([z, z, g], -1)


def meridian_prime_vertical_radius(lat: torch.Tensor):
    """(R_meridian, R_prime_vertical) at geodetic latitude."""
    t = 1.0 - WGS84_E1 * torch.sin(lat) ** 2
    sq = torch.sqrt(t)
    return WGS84_RA * (1.0 - WGS84_E1) / (sq * t), WGS84_RA / sq


def rn(lat: torch.Tensor) -> torch.Tensor:
    """Prime vertical radius of curvature."""
    return WGS84_RA / torch.sqrt(1.0 - WGS84_E1 * torch.sin(lat) ** 2)


def cne(blh: torch.Tensor) -> torch.Tensor:
    """C_ne with v_e = C_ne @ v_n (NED at blh to ECEF)."""
    sinlat, coslat = torch.sin(blh[..., 0]), torch.cos(blh[..., 0])
    sinlon, coslon = torch.sin(blh[..., 1]), torch.cos(blh[..., 1])
    return torch.stack(
        [
            torch.stack([-sinlat * coslon, -sinlon, -coslat * coslon], -1),
            torch.stack([-sinlat * sinlon, coslon, -coslat * sinlon], -1),
            torch.stack([coslat, torch.zeros_like(coslat), -sinlat], -1),
        ],
        -2,
    )


def qne(blh: torch.Tensor) -> torch.Tensor:
    """Quaternion equivalent of cne (scalar-first)."""
    coslon = torch.cos(blh[..., 1] * 0.5)
    sinlon = torch.sin(blh[..., 1] * 0.5)
    coslat = torch.cos(-math.pi * 0.25 - blh[..., 0] * 0.5)
    sinlat = torch.sin(-math.pi * 0.25 - blh[..., 0] * 0.5)
    return torch.stack(
        [coslat * coslon, -sinlat * sinlon, sinlat * coslon, coslat * sinlon], -1
    )


def blh_from_qne(q: torch.Tensor, height: torch.Tensor) -> torch.Tensor:
    """Recover [lat, lon, h] from the n->e quaternion plus height."""
    lat = -2.0 * torch.atan(q[..., 2] / q[..., 0]) - math.pi * 0.5
    lon = 2.0 * torch.atan2(q[..., 3], q[..., 0])
    return torch.stack([lat, lon, torch.as_tensor(height).expand_as(lat)], -1)


def blh_to_ecef(blh: torch.Tensor) -> torch.Tensor:
    coslat, sinlat = torch.cos(blh[..., 0]), torch.sin(blh[..., 0])
    coslon, sinlon = torch.cos(blh[..., 1]), torch.sin(blh[..., 1])
    r = rn(blh[..., 0])
    rh = r + blh[..., 2]
    return torch.stack(
        [rh * coslat * coslon, rh * coslat * sinlon, (rh - r * WGS84_E1) * sinlat], -1
    )


def ecef_to_blh(ecef: torch.Tensor) -> torch.Tensor:
    """ECEF -> geodetic, 5 rounds of the fixed-point iteration."""
    p = torch.sqrt(ecef[..., 0] ** 2 + ecef[..., 1] ** 2)
    lon = 2.0 * torch.atan2(ecef[..., 1], ecef[..., 0] + p)
    lat = torch.atan(ecef[..., 2] / (p * (1.0 - WGS84_E1)))
    h = torch.zeros_like(lat)
    for _ in range(5):
        r = rn(lat)
        h = p / torch.cos(lat) - r
        lat = torch.atan(ecef[..., 2] / (p * (1.0 - WGS84_E1 * r / (r + h))))
    return torch.stack([lat, lon, h], -1)


def _diag3(d0, d1, d2):
    return torch.diag_embed(torch.stack([d0, d1, d2], -1))


def dri(blh: torch.Tensor) -> torch.Tensor:
    """d(blh)/d(NED position), diagonal."""
    rm, rnv = meridian_prime_vertical_radius(blh[..., 0])
    h = blh[..., 2]
    d0 = 1.0 / (rm + h)
    return _diag3(d0, 1.0 / ((rnv + h) * torch.cos(blh[..., 0])), -torch.ones_like(d0))


def dr(blh: torch.Tensor) -> torch.Tensor:
    """d(NED position)/d(blh), diagonal."""
    rm, rnv = meridian_prime_vertical_radius(blh[..., 0])
    h = blh[..., 2]
    d0 = rm + h
    return _diag3(d0, (rnv + h) * torch.cos(blh[..., 0]), -torch.ones_like(d0))


def local_to_global(origin_blh: torch.Tensor, local_ned: torch.Tensor) -> torch.Tensor:
    """Point in the station NED frame -> geodetic blh."""
    return ecef_to_blh(blh_to_ecef(origin_blh) + mv(cne(origin_blh), local_ned))


def global_to_local(origin_blh: torch.Tensor, global_blh: torch.Tensor) -> torch.Tensor:
    """Geodetic blh -> point in the station NED frame."""
    d = blh_to_ecef(global_blh) - blh_to_ecef(origin_blh)
    return mv(cne(origin_blh).transpose(-1, -2), d)


def pose_local_to_global(origin_blh, r_local, t_local):
    """(R, t) in the station NED frame -> (R_global, blh); R_global is
    body -> local NED at the new position."""
    c0 = cne(origin_blh)
    blh1 = ecef_to_blh(blh_to_ecef(origin_blh) + mv(c0, t_local))
    c1 = cne(blh1)
    return c1.transpose(-1, -2) @ c0 @ r_local, blh1


def pose_global_to_local(origin_blh, r_global, blh1):
    """Inverse of pose_local_to_global."""
    c0t = cne(origin_blh).transpose(-1, -2)
    t_local = mv(c0t, blh_to_ecef(blh1) - blh_to_ecef(origin_blh))
    return c0t @ cne(blh1) @ r_global, t_local


def iewe(dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, WGS84_WIE], dtype=dtype, device=device)


def iewn(lat: torch.Tensor) -> torch.Tensor:
    """Earth rotation rate in the NED n-frame at latitude."""
    return torch.stack(
        [WGS84_WIE * torch.cos(lat), torch.zeros_like(lat), -WGS84_WIE * torch.sin(lat)], -1
    )


def iewn_at(origin_blh: torch.Tensor, local_ned: torch.Tensor) -> torch.Tensor:
    """Earth rate in the n-frame at a local NED position."""
    return iewn(local_to_global(origin_blh, local_ned)[..., 0])


def enwn(rmn, blh: torch.Tensor, vel_ned: torch.Tensor) -> torch.Tensor:
    """Transport rate (the fusion path drops it, as the reference does)."""
    rm, rnv = rmn
    h = blh[..., 2]
    return torch.stack(
        [
            vel_ned[..., 1] / (rnv + h),
            -vel_ned[..., 0] / (rm + h),
            -vel_ned[..., 1] * torch.tan(blh[..., 0]) / (rnv + h),
        ],
        -1,
    )
