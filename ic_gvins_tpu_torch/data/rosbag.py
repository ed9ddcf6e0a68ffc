"""A ROS bag (format 2.0) reader and dataset converter (``data/rosbag.py``),
numpy only.

The reference is fed by ``rosbag play`` (KAIST urban38/39 bags) into three
subscribers (``fusion_ros.cc:117-120``): ``sensor_msgs/Imu``,
``sensor_msgs/NavSatFix`` and ``sensor_msgs/Image``. This module reads bag
files directly, record grammar per the rosbag 2.0 spec (header-len /
header / data-len / data records; op 0x03 bag header, 0x05 chunk [none or
bz2 compression], 0x07 connection, 0x02 message data), and deserializes
the three message types by hand (little-endian ROS serialization).

``convert_bag`` replays a bag into the KAIST-style CSV layout that
``data/kaist.py`` loads (xsens_imu.csv / vrs_gps.csv column conventions)
plus an image directory of PNGs (``data/image.py``'s writer), so any
reference-compatible bag feeds the offline pipeline without ROS.
"""

import bz2
import os
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from .image import write_png

_MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> dict:
    """A record header: sequence of <len u32><name=value> fields."""
    fields = {}
    off = 0
    while off < len(buf):
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + n]
        off += n
        eq = field.index(b"=")
        fields[field[:eq].decode()] = field[eq + 1 :]
    return fields


def _records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    """Iterate <header><data> records in a byte buffer."""
    off = 0
    n_total = len(buf)
    while off + 8 <= n_total:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


class _Reader:
    """Cursor over little-endian ROS-serialized message bytes."""

    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u8(self):
        v = self.d[self.o]
        self.o += 1
        return v

    def i8(self):
        (v,) = struct.unpack_from("<b", self.d, self.o)
        self.o += 1
        return v

    def u16(self):
        (v,) = struct.unpack_from("<H", self.d, self.o)
        self.o += 2
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.d, self.o)
        self.o += 4
        return v

    def f64(self, n=1):
        v = struct.unpack_from(f"<{n}d", self.d, self.o)
        self.o += 8 * n
        return v[0] if n == 1 else np.asarray(v)

    def string(self):
        n = self.u32()
        s = self.d[self.o : self.o + n]
        self.o += n
        return s.decode(errors="replace")

    def time(self):
        return self.u32() + 1e-9 * self.u32()

    def bytes_(self):
        n = self.u32()
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    def header(self):
        self.u32()  # seq
        stamp = self.time()
        frame_id = self.string()
        return stamp, frame_id


def _parse_imu(data: bytes) -> dict:
    r = _Reader(data)
    stamp, frame = r.header()
    quat = np.asarray([r.f64(), r.f64(), r.f64(), r.f64()])  # x y z w
    r.f64(9)  # orientation covariance
    gyro = np.asarray([r.f64(), r.f64(), r.f64()])
    r.f64(9)
    accel = np.asarray([r.f64(), r.f64(), r.f64()])
    r.f64(9)
    return dict(stamp=stamp, frame_id=frame, orientation=quat,
                angular_velocity=gyro, linear_acceleration=accel)


def _parse_navsatfix(data: bytes) -> dict:
    r = _Reader(data)
    stamp, frame = r.header()
    status = r.i8()
    service = r.u16()
    lat, lon, alt = r.f64(), r.f64(), r.f64()
    cov = r.f64(9).reshape(3, 3)
    cov_type = r.u8()
    return dict(stamp=stamp, frame_id=frame, status=status, service=service,
                latitude=lat, longitude=lon, altitude=alt,
                position_covariance=cov, position_covariance_type=cov_type)


def _parse_image(data: bytes) -> dict:
    r = _Reader(data)
    stamp, frame = r.header()
    h, w = r.u32(), r.u32()
    encoding = r.string()
    r.u8()  # is_bigendian
    step = r.u32()
    raw = r.bytes_()
    img = None
    if encoding in ("mono8", "8UC1"):
        img = np.frombuffer(raw, np.uint8).reshape(h, step)[:, :w]
    elif encoding in ("bgr8", "rgb8", "8UC3"):
        arr = np.frombuffer(raw, np.uint8).reshape(h, step)[:, : w * 3]
        arr = arr.reshape(h, w, 3).astype(np.float32)
        order = (2, 1, 0) if encoding == "bgr8" else (0, 1, 2)
        # ITU-R BT.601 luma — the reference converts to gray at ingest
        img = (
            0.299 * arr[..., order[0]]
            + 0.587 * arr[..., order[1]]
            + 0.114 * arr[..., order[2]]
        ).astype(np.uint8)
    elif encoding == "bayer_rggb8":
        # KAIST cameras publish Bayer; a 2x2 box demosaic to gray is
        # enough for the luminance-based front-end
        arr = np.frombuffer(raw, np.uint8).reshape(h, step)[:, :w]
        a = arr.astype(np.float32)
        g = 0.25 * (a[0::2, 0::2] + a[0::2, 1::2] + a[1::2, 0::2] + a[1::2, 1::2])
        img = np.repeat(np.repeat(g, 2, axis=0), 2, axis=1)[:h, :w].astype(np.uint8)
    return dict(stamp=stamp, frame_id=frame, height=h, width=w,
                encoding=encoding, image=img)


_PARSERS = {
    "sensor_msgs/Imu": _parse_imu,
    "sensor_msgs/NavSatFix": _parse_navsatfix,
    "sensor_msgs/Image": _parse_image,
}


@dataclass
class BagMessage:
    topic: str
    type: str
    time: float  # bag receive time (s)
    msg: dict | bytes  # parsed dict for supported types, raw bytes otherwise


def read_bag(path: str, topics: list[str] | None = None,
             parse: bool = True) -> Iterator[BagMessage]:
    """Stream messages from a ROS bag v2.0 file in record order.

    Supports uncompressed and bz2 chunks (lz4 raises). Unsupported message
    types yield raw serialized bytes when ``parse`` is True.
    """
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 file")
        buf = f.read()

    connections: dict[int, tuple[str, str]] = {}  # conn id -> (topic, type)

    def handle(header: dict, data: bytes) -> Iterator[BagMessage]:
        op = header["op"][0]
        if op == OP_CONNECTION:
            conn = struct.unpack("<I", header["conn"])[0]
            fields = _parse_header(data)
            topic = header.get("topic", b"").decode()
            mtype = fields.get("type", b"").decode()
            connections[conn] = (topic, mtype)
        elif op == OP_MSG:
            conn = struct.unpack("<I", header["conn"])[0]
            secs, nsecs = struct.unpack("<II", header["time"])
            topic, mtype = connections.get(conn, ("?", "?"))
            if topics is not None and topic not in topics:
                return
            msg: dict | bytes = data
            if parse and mtype in _PARSERS:
                msg = _PARSERS[mtype](data)
            yield BagMessage(topic, mtype, secs + 1e-9 * nsecs, msg)
        elif op == OP_CHUNK:
            compression = header.get("compression", b"none").decode()
            if compression == "none":
                chunk = data
            elif compression == "bz2":
                chunk = bz2.decompress(data)
            else:
                raise NotImplementedError(f"chunk compression {compression}")
            for h2, d2 in _records(chunk):
                yield from handle(h2, d2)
        # OP_BAG_HEADER / OP_INDEX / OP_CHUNK_INFO: skipped (stream scan)

    for header, data in _records(buf):
        yield from handle(header, data)


def bag_topics(path: str) -> dict[str, str]:
    """Map topic -> message type (scans connection records)."""
    with open(path, "rb") as f:
        f.read(len(_MAGIC))
        buf = f.read()
    conns = {}

    def scan(header, data):
        op = header["op"][0]
        if op == OP_CONNECTION:
            fields = _parse_header(data)
            conns[header.get("topic", b"").decode()] = fields.get(
                "type", b""
            ).decode()
        elif op == OP_CHUNK:
            compression = header.get("compression", b"none").decode()
            chunk = data if compression == "none" else bz2.decompress(data)
            for h2, d2 in _records(chunk):
                scan(h2, d2)

    for header, data in _records(buf):
        scan(header, data)
    return conns


def convert_bag(
    path: str,
    outdir: str,
    imu_topic: str = "/imu/data_raw",
    gnss_topic: str = "/gps/fix",
    image_topic: str | None = None,
    image_format: str = "png",
) -> dict:
    """Convert a reference-compatible bag to the KAIST-style layout that
    ``data/kaist.py`` loads: ``sensor_data/xsens_imu.csv`` (time_ns, quat x4,
    euler x3, gyro x3, accel x3 — the default ``ImuColumns``),
    ``sensor_data/vrs_gps.csv`` (time_ns, lat, lon, alt, std x3 =
    ``GpsColumns(std=(4,5,6))``), and images under ``image/`` named by
    nanosecond stamp. Returns counters."""
    os.makedirs(os.path.join(outdir, "sensor_data"), exist_ok=True)
    imgdir = os.path.join(outdir, "image")
    n_imu = n_gnss = n_img = 0
    imu_rows = []
    gps_rows = []
    topics = [imu_topic, gnss_topic] + ([image_topic] if image_topic else [])
    for m in read_bag(path, topics=topics):
        if m.topic == imu_topic and isinstance(m.msg, dict):
            t_ns = int(round(m.msg["stamp"] * 1e9))
            q = m.msg["orientation"]
            w = m.msg["angular_velocity"]
            a = m.msg["linear_acceleration"]
            imu_rows.append(
                [t_ns, q[0], q[1], q[2], q[3], 0.0, 0.0, 0.0,
                 w[0], w[1], w[2], a[0], a[1], a[2]]
            )
            n_imu += 1
        elif m.topic == gnss_topic and isinstance(m.msg, dict):
            t_ns = int(round(m.msg["stamp"] * 1e9))
            cov = m.msg["position_covariance"]
            std = np.sqrt(np.maximum(np.diag(cov), 0.0))
            gps_rows.append(
                [t_ns, m.msg["latitude"], m.msg["longitude"],
                 m.msg["altitude"], std[0], std[1], std[2]]
            )
            n_gnss += 1
        elif image_topic and m.topic == image_topic and isinstance(m.msg, dict):
            img = m.msg["image"]
            if img is None:
                continue
            os.makedirs(imgdir, exist_ok=True)
            t_ns = int(round(m.msg["stamp"] * 1e9))
            if image_format == "png":
                write_png(os.path.join(imgdir, f"{t_ns}.png"), img)
            else:
                np.save(os.path.join(imgdir, f"{t_ns}.npy"), img)
            n_img += 1

    def _write(name, rows, fmt):
        with open(os.path.join(outdir, "sensor_data", name), "w") as f:
            for row in rows:
                f.write(fmt(row) + "\n")

    _write("xsens_imu.csv", imu_rows,
           lambda r: ",".join([str(int(r[0]))] + [f"{x:.9g}" for x in r[1:]]))
    _write("vrs_gps.csv", gps_rows,
           lambda r: ",".join([str(int(r[0]))] + [f"{x:.12g}" for x in r[1:]]))
    return dict(imu=n_imu, gnss=n_gnss, images=n_img)
