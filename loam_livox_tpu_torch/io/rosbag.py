"""Pure-Python ROS1 bag (format 2.0) reader/writer + message codecs.

A copy of ``loam_livox_tpu/io/rosbag.py`` (numpy only; the port imports
nothing of the JAX package).

The reference consumes its curated datasets as rosbags replayed into the
two nodes (reference ``README.md:76-137``, ``launch/rosbag.launch:1-25``;
the front-end subscribes raw clouds in
``laser_feature_extractor.hpp:173-190``).  This module removes the ROS
dependency: it parses the on-disk bag container directly and decodes the
two point-cloud message types those datasets carry —

* ``sensor_msgs/PointCloud2``  (Velodyne + converted captures),
* ``livox_ros_driver/CustomMsg`` (native Livox driver output).

Also provides a writer (same container layout: bag header, one or more
chunks holding connection+message records, per-chunk index data,
trailing connection + chunk-info records) so fixtures and converted
captures can be produced without ROS — files written here are valid
format-2.0 bags readable by standard ROS tooling.

Container spec implemented from the public rosbag format description
(http://wiki.ros.org/Bags/Format/2.0): records are
``<u32 header_len><header><u32 data_len><data>``; headers are
``<u32 field_len>name=value`` sequences; opcodes: 0x02 message data,
0x03 bag header, 0x04 index data, 0x05 chunk, 0x06 chunk info,
0x07 connection.  Chunk compression: ``none`` and ``bz2`` supported
(``lz4`` decoded when the lz4 package is importable).

Host-side on purpose — this is the I/O boundary, not the compute path.
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07

MAGIC = b"#ROSBAG V2.0\n"


# ---------------------------------------------------------------------------
# Record / header primitives
# ---------------------------------------------------------------------------

def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    pos = 0
    n = len(buf)
    while pos + 4 <= n:
        (flen,) = _U32.unpack_from(buf, pos)
        pos += 4
        f = buf[pos: pos + flen]
        pos += flen
        eq = f.find(b"=")
        if eq >= 0:
            fields[f[:eq]] = f[eq + 1:]
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = bytearray()
    for k, v in fields.items():
        f = k + b"=" + v
        out += _U32.pack(len(f)) + f
    return bytes(out)


def _read_record(buf: bytes, pos: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    """Returns (header_fields, data, next_pos)."""
    (hlen,) = _U32.unpack_from(buf, pos)
    pos += 4
    header = _parse_header(buf[pos: pos + hlen])
    pos += hlen
    (dlen,) = _U32.unpack_from(buf, pos)
    pos += 4
    data = buf[pos: pos + dlen]
    return header, data, pos + dlen


def _encode_record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    h = _encode_header(fields)
    return _U32.pack(len(h)) + h + _U32.pack(len(data)) + data


def _ros_time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 10**9:
        secs, nsecs = secs + 1, nsecs - 10**9
    return struct.pack("<II", secs, nsecs)


def _ros_time_to_float(b: bytes) -> float:
    secs, nsecs = struct.unpack_from("<II", b)
    return secs + nsecs * 1e-9


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

@dataclass
class Connection:
    conn_id: int
    topic: str
    datatype: str
    md5sum: str = ""
    message_definition: str = ""


@dataclass
class BagMessage:
    topic: str
    datatype: str
    time: float
    raw: bytes


class BagReader:
    """Sequential bag reader.  Scans chunk records in file order (the
    trailing index is not required — truncated bags still replay up to
    the damage point)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        if not self._buf.startswith(MAGIC):
            raise ValueError(f"{path}: not a ROS bag v2.0 (bad magic)")
        self.connections: Dict[int, Connection] = {}

    # -- container walk ----------------------------------------------------
    def _records(self, buf: bytes, pos: int, end: int):
        while pos < end:
            header, data, pos = _read_record(buf, pos)
            yield header, data

    def messages(self, topics: Optional[List[str]] = None
                 ) -> Iterator[BagMessage]:
        buf = self._buf
        pos = len(MAGIC)
        n = len(buf)
        want = set(topics) if topics else None
        while pos < n:
            try:
                header, data, pos = _read_record(buf, pos)
            except (struct.error, ValueError):
                # Truncated / damaged tail: replay stops at the damage
                # point (matching the class docstring contract) instead
                # of surfacing a parser internal.
                import warnings

                warnings.warn(
                    f"bag damaged/truncated at byte {pos}; stopping replay")
                return
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CHUNK:
                compression = header.get(b"compression", b"none").decode()
                if compression == "bz2":
                    data = bz2.decompress(data)
                elif compression == "lz4":
                    try:
                        import lz4.frame  # type: ignore

                        data = lz4.frame.decompress(data)
                    except ImportError as e:
                        raise RuntimeError(
                            "bag chunk is lz4-compressed and the lz4 "
                            "package is unavailable") from e
                elif compression != "none":
                    raise RuntimeError(
                        f"unsupported chunk compression {compression!r}")
                yield from self._chunk_messages(data, want)
            elif op == OP_CONNECTION:
                self._add_connection(header, data)
            # message data outside chunks is legal (format 1.x style)
            elif op == OP_MSG:
                m = self._decode_msg_record(header, data, want)
                if m:
                    yield m
            # index / chunk info / bag header records: skip

    def _chunk_messages(self, data: bytes, want) -> Iterator[BagMessage]:
        pos = 0
        n = len(data)
        while pos < n:
            try:
                header, rec, pos = _read_record(data, pos)
            except (struct.error, ValueError):
                import warnings

                warnings.warn(
                    f"bag chunk damaged at byte {pos}; skipping its tail")
                return
            op = header.get(b"op", b"\x00")[0]
            if op == OP_CONNECTION:
                self._add_connection(header, rec)
            elif op == OP_MSG:
                m = self._decode_msg_record(header, rec, want)
                if m:
                    yield m

    def _add_connection(self, header, data) -> None:
        conn_id = _U32.unpack(header[b"conn"])[0]
        topic = header.get(b"topic", b"").decode()
        inner = _parse_header(data)
        self.connections[conn_id] = Connection(
            conn_id=conn_id,
            topic=inner.get(b"topic", topic.encode()).decode() or topic,
            datatype=inner.get(b"type", b"").decode(),
            md5sum=inner.get(b"md5sum", b"").decode(),
            message_definition=inner.get(b"message_definition", b"").decode(),
        )

    def _decode_msg_record(self, header, data, want) -> Optional[BagMessage]:
        try:
            conn_id = _U32.unpack(header[b"conn"])[0]
        except (KeyError, struct.error):
            return None            # damaged record header: skip
        conn = self.connections.get(conn_id)
        if conn is None:
            return None
        if want is not None and conn.topic not in want:
            return None
        return BagMessage(topic=conn.topic, datatype=conn.datatype,
                          time=_ros_time_to_float(header[b"time"]),
                          raw=data)

    def topics(self) -> Dict[str, str]:
        """topic → datatype map (walks the whole file once)."""
        for _ in self.messages(topics=[]):
            pass
        return {c.topic: c.datatype for c in self.connections.values()}


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class BagWriter:
    """Minimal but spec-complete bag writer: single chunk per `flush`
    (or everything in one chunk at close), per-chunk index-data records,
    trailing connection + chunk-info records, back-patched bag header."""

    def __init__(self, path: str, compression: str = "none"):
        if compression not in ("none", "bz2"):
            raise ValueError("compression must be 'none' or 'bz2'")
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._compression = compression
        # bag header placeholder (patched on close); record padded to
        # 4096 bytes with an 0x20-filled data section, as rosbag does
        self._bag_header_pos = self._f.tell()
        self._write_bag_header(0, 0, 0)
        self._conns: Dict[Tuple[str, str], int] = {}
        self._conn_records: List[bytes] = []
        self._pending: List[Tuple[int, float, bytes]] = []
        self._chunk_infos: List[dict] = []
        self._closed = False

    def _write_bag_header(self, index_pos: int, conn_count: int,
                          chunk_count: int) -> None:
        h = _encode_header({
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": _U64.pack(index_pos),
            b"conn_count": _U32.pack(conn_count),
            b"chunk_count": _U32.pack(chunk_count),
        })
        pad = 4096 - len(h) - 8
        rec = _U32.pack(len(h)) + h + _U32.pack(pad) + b" " * pad
        self._f.write(rec)

    def add_connection(self, topic: str, datatype: str, md5sum: str = "*",
                       message_definition: str = "") -> int:
        key = (topic, datatype)
        if key in self._conns:
            return self._conns[key]
        conn_id = len(self._conns)
        self._conns[key] = conn_id
        inner = _encode_header({
            b"topic": topic.encode(),
            b"type": datatype.encode(),
            b"md5sum": md5sum.encode(),
            b"message_definition": message_definition.encode(),
        })
        rec = _encode_record({
            b"op": bytes([OP_CONNECTION]),
            b"conn": _U32.pack(conn_id),
            b"topic": topic.encode(),
        }, inner)
        self._conn_records.append(rec)
        return conn_id

    def write(self, topic: str, datatype: str, t: float, raw: bytes) -> None:
        conn_id = self.add_connection(topic, datatype)
        self._pending.append((conn_id, t, raw))

    def flush(self) -> None:
        """Emit pending messages as one chunk + its index records."""
        if not self._pending:
            return
        chunk = bytearray()
        for rec in self._conn_records:  # connections repeat inside chunks
            chunk += rec
        index: Dict[int, List[Tuple[float, int]]] = {}
        for conn_id, t, raw in self._pending:
            offset = len(chunk)
            chunk += _encode_record({
                b"op": bytes([OP_MSG]),
                b"conn": _U32.pack(conn_id),
                b"time": _ros_time(t),
            }, raw)
            index.setdefault(conn_id, []).append((t, offset))

        payload = bytes(chunk)
        if self._compression == "bz2":
            payload = bz2.compress(payload)
        chunk_pos = self._f.tell()
        self._f.write(_encode_record({
            b"op": bytes([OP_CHUNK]),
            b"compression": self._compression.encode(),
            b"size": _U32.pack(len(chunk)),
        }, payload))

        times = [t for _, t, _ in self._pending]
        for conn_id, entries in sorted(index.items()):
            data = b"".join(_ros_time(t) + _U32.pack(off)
                            for t, off in entries)
            self._f.write(_encode_record({
                b"op": bytes([OP_INDEX]),
                b"ver": _U32.pack(1),
                b"conn": _U32.pack(conn_id),
                b"count": _U32.pack(len(entries)),
            }, data))
        self._chunk_infos.append({
            "pos": chunk_pos,
            "start": min(times),
            "end": max(times),
            "counts": {cid: len(v) for cid, v in index.items()},
        })
        self._pending.clear()

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        index_pos = self._f.tell()
        for rec in self._conn_records:
            self._f.write(rec)
        for info in self._chunk_infos:
            data = b"".join(_U32.pack(cid) + _U32.pack(cnt)
                            for cid, cnt in sorted(info["counts"].items()))
            self._f.write(_encode_record({
                b"op": bytes([OP_CHUNK_INFO]),
                b"ver": _U32.pack(1),
                b"chunk_pos": _U64.pack(info["pos"]),
                b"start_time": _ros_time(info["start"]),
                b"end_time": _ros_time(info["end"]),
                b"count": _U32.pack(len(info["counts"])),
            }, data))
        self._f.seek(self._bag_header_pos)
        self._write_bag_header(index_pos, len(self._conns),
                               len(self._chunk_infos))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Message codecs
# ---------------------------------------------------------------------------

_PF_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}
_PF_CODE = {np.dtype(v): k for k, v in _PF_DTYPES.items()}


def _read_string(buf: bytes, pos: int) -> Tuple[str, int]:
    (n,) = _U32.unpack_from(buf, pos)
    pos += 4
    return buf[pos: pos + n].decode(errors="replace"), pos + n


def _read_ros_header(buf: bytes, pos: int) -> Tuple[float, int]:
    """std_msgs/Header → (stamp_seconds, next_pos)."""
    pos += 4  # seq
    secs, nsecs = struct.unpack_from("<II", buf, pos)
    pos += 8
    _, pos = _read_string(buf, pos)  # frame_id
    return secs + nsecs * 1e-9, pos


@dataclass
class PointCloud2:
    stamp: float
    xyz: np.ndarray                      # (N, 3) float32
    intensity: Optional[np.ndarray]      # (N,) float32 or None
    extra: Dict[str, np.ndarray] = field(default_factory=dict)


def decode_pointcloud2(raw: bytes,
                       extra_fields: Tuple[str, ...] = ()) -> PointCloud2:
    """sensor_msgs/PointCloud2 wire format → arrays (vectorized via a
    numpy structured view over the data blob)."""
    stamp, pos = _read_ros_header(raw, 0)
    height, width = struct.unpack_from("<II", raw, pos)
    pos += 8
    (nfields,) = _U32.unpack_from(raw, pos)
    pos += 4
    fields = []
    for _ in range(nfields):
        name, pos = _read_string(raw, pos)
        offset, datatype, count = struct.unpack_from("<IBI", raw, pos)
        pos += 9
        fields.append((name, offset, datatype, count))
    is_bigendian = raw[pos]
    pos += 1
    point_step, row_step = struct.unpack_from("<II", raw, pos)
    pos += 8
    (data_len,) = _U32.unpack_from(raw, pos)
    pos += 4
    blob = raw[pos: pos + data_len]
    pos += data_len
    # trailing is_dense byte ignored
    if is_bigendian:
        raise ValueError("big-endian PointCloud2 not supported")

    n = height * width
    if point_step == 0 or n == 0:
        return PointCloud2(stamp, np.zeros((0, 3), np.float32), None)
    n = min(n, len(blob) // point_step)

    names, formats, offsets = [], [], []
    for name, offset, datatype, count in fields:
        dt = _PF_DTYPES.get(datatype)
        if dt is None:
            continue
        names.append(name)
        formats.append(dt if count == 1 else (dt, (count,)))
        offsets.append(offset)
    view = np.frombuffer(blob, dtype=np.dtype({
        "names": names, "formats": formats, "offsets": offsets,
        "itemsize": point_step}), count=n)

    def col(name):
        return np.ascontiguousarray(view[name]).astype(np.float32) \
            if name in names else None

    x, y, z = col("x"), col("y"), col("z")
    if x is None or y is None or z is None:
        raise ValueError("PointCloud2 missing x/y/z fields")
    xyz = np.stack([x, y, z], axis=1)
    extra = {f: col(f) for f in extra_fields if col(f) is not None}
    return PointCloud2(stamp, xyz, col("intensity"), extra)


def encode_pointcloud2(stamp: float, xyz: np.ndarray,
                       intensity: Optional[np.ndarray] = None,
                       frame_id: str = "livox") -> bytes:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    point_step = 12
    if intensity is not None:
        fields.append(("intensity", 12, 7, 1))
        point_step = 16
    out = bytearray()
    out += _U32.pack(0)                          # seq
    out += _ros_time(stamp)
    fid = frame_id.encode()
    out += _U32.pack(len(fid)) + fid
    out += struct.pack("<II", 1, n)              # height, width
    out += _U32.pack(len(fields))
    for name, off, dt, cnt in fields:
        nm = name.encode()
        out += _U32.pack(len(nm)) + nm
        out += struct.pack("<IBI", off, dt, cnt)
    out += b"\x00"                               # is_bigendian
    out += struct.pack("<II", point_step, point_step * n)
    cols = [xyz]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32)[:, None])
    blob = np.concatenate(cols, axis=1).astype("<f4").tobytes()
    out += _U32.pack(len(blob)) + blob
    out += b"\x01"                               # is_dense
    return bytes(out)


@dataclass
class LivoxCustomMsg:
    stamp: float
    timebase_ns: int
    lidar_id: int
    xyz: np.ndarray              # (N, 3) float32
    reflectivity: np.ndarray     # (N,) float32
    offset_time_ns: np.ndarray   # (N,) uint32
    tag: np.ndarray              # (N,) uint8
    line: np.ndarray             # (N,) uint8


_CUSTOM_POINT = np.dtype([
    ("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1"),
])


def decode_livox_custommsg(raw: bytes) -> LivoxCustomMsg:
    """livox_ros_driver/CustomMsg wire format → arrays."""
    stamp, pos = _read_ros_header(raw, 0)
    (timebase,) = _U64.unpack_from(raw, pos)
    pos += 8
    (point_num,) = _U32.unpack_from(raw, pos)
    pos += 4
    lidar_id = raw[pos]
    pos += 1 + 3                                  # lidar_id + rsvd[3]
    (count,) = _U32.unpack_from(raw, pos)
    pos += 4
    count = min(count, point_num,
                (len(raw) - pos) // _CUSTOM_POINT.itemsize)
    pts = np.frombuffer(raw, dtype=_CUSTOM_POINT, count=count, offset=pos)
    xyz = np.stack([pts["x"], pts["y"], pts["z"]], axis=1).astype(np.float32)
    return LivoxCustomMsg(
        stamp=stamp, timebase_ns=int(timebase), lidar_id=int(lidar_id),
        xyz=xyz,
        reflectivity=pts["reflectivity"].astype(np.float32),
        offset_time_ns=np.ascontiguousarray(pts["offset_time"]),
        tag=np.ascontiguousarray(pts["tag"]),
        line=np.ascontiguousarray(pts["line"]),
    )


def encode_livox_custommsg(stamp: float, xyz: np.ndarray,
                           reflectivity: np.ndarray,
                           offset_time_ns: Optional[np.ndarray] = None,
                           lidar_id: int = 0,
                           frame_id: str = "livox_frame") -> bytes:
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    out = bytearray()
    out += _U32.pack(0)
    out += _ros_time(stamp)
    fid = frame_id.encode()
    out += _U32.pack(len(fid)) + fid
    out += _U64.pack(int(stamp * 1e9))            # timebase
    out += _U32.pack(n)                           # point_num
    out += bytes([lidar_id, 0, 0, 0])             # lidar_id + rsvd
    out += _U32.pack(n)                           # points array length
    pts = np.zeros(n, dtype=_CUSTOM_POINT)
    if offset_time_ns is None:
        # reference per-point spacing: 10 µs (livox_feature_extractor.hpp:145)
        offset_time_ns = (np.arange(n) * 10_000).astype(np.uint32)
    pts["offset_time"] = offset_time_ns
    pts["x"], pts["y"], pts["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    pts["reflectivity"] = np.clip(np.asarray(reflectivity), 0, 255
                                  ).astype(np.uint8)
    out += pts.tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# Frame stream over a bag (the CLI ingest path)
# ---------------------------------------------------------------------------

POINT_TOPIC_TYPES = ("sensor_msgs/PointCloud2", "livox_ros_driver/CustomMsg",
                     "livox_ros_driver2/CustomMsg")


def bag_frame_stream(path: str, topic: Optional[str] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
    """Yield (xyz float32 (N,3), intensity (N,), stamp_seconds) per
    point-cloud message.  With no topic given, auto-selects the first
    point-cloud-typed topic seen (reference remaps its input topic per
    launch file; this is the no-ROS equivalent)."""
    reader = BagReader(path)
    chosen = topic
    for msg in reader.messages(topics=[topic] if topic else None):
        if msg.datatype not in POINT_TOPIC_TYPES:
            continue
        if chosen is None:
            chosen = msg.topic
        elif msg.topic != chosen:
            continue
        if msg.datatype == "sensor_msgs/PointCloud2":
            pc = decode_pointcloud2(msg.raw)
            inten = pc.intensity
            if inten is None:
                inten = np.ones(len(pc.xyz), np.float32)
            yield pc.xyz, inten, pc.stamp if pc.stamp > 0 else msg.time
        else:
            m = decode_livox_custommsg(msg.raw)
            yield m.xyz, m.reflectivity, m.stamp if m.stamp > 0 else msg.time
