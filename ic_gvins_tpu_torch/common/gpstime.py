"""GPS time conversions (unix <-> GPS week/seconds-of-week).

Parity with the reference (``ic_gvins/common/gpstime.h:34-43``).
Plain Python/NumPy-compatible scalars — this runs on host at ingest only.
"""

from __future__ import annotations

SECONDS_PER_WEEK = 604800.0
GPS_UNIX_EPOCH_OFFSET = 315964800.0  # 1980-01-06T00:00:00Z in unix seconds
LEAP_SECONDS = 18.0


def unix_to_gps(unix_s):
    """Unix seconds -> (gps_week, seconds_of_week)."""
    t = unix_s - GPS_UNIX_EPOCH_OFFSET + LEAP_SECONDS
    week = int(t // SECONDS_PER_WEEK)
    sow = t - week * SECONDS_PER_WEEK
    return week, sow


def gps_to_unix(week, sow):
    """(gps_week, seconds_of_week) -> unix seconds."""
    return week * SECONDS_PER_WEEK + sow + GPS_UNIX_EPOCH_OFFSET - LEAP_SECONDS
