"""Livox ``.lvx`` capture file reader/writer (format v1.1).

A copy of ``loam_livox_tpu/io/lvx.py`` (numpy only; the port imports
nothing of the JAX package).

The Livox Viewer / SDK records raw sensor output as .lvx files; the
reference's datasets circulate both as rosbags and as .lvx captures
(converted by ``livox_ros_driver``'s lvx_to_rosbag).  This decoder makes
those captures directly ingestible without ROS or the Livox SDK.

Layout (public LVX Specifications v1.1):
* public header (24 B): signature ``char[16]`` = "livox_tech", version
  ``uchar[4]`` = {1,1,0,0}, magic ``uint32`` = 0xAC0EA767,
* private header (5 B): frame duration ms ``uint32`` (50), device count
  ``uint8``,
* device info ×N (59 B each): broadcast codes ``char[16]``×2, device
  index/type, extrinsic enable, roll/pitch/yaw/x/y/z ``float32``,
* frames: header (24 B: current/next offset ``uint64``×2, frame index
  ``uint64``) followed by packages up to ``next_offset``,
* package (19 B header: device idx, version, slot, lidar id, rsvd,
  status ``uint32``, timestamp type, data type, timestamp ``uint64`` ns)
  + a fixed-size point block per data type:
    0: 100 × {x,y,z int32 mm, reflectivity u8}          (13 B)
    1: 100 × {depth u32 mm, theta u16, phi u16, r u8}   ( 9 B)
    2:  96 × {x,y,z int32 mm, reflectivity u8, tag u8}  (14 B)
    3:  96 × {depth u32, theta u16, phi u16, r u8, tag} (10 B)
    5:  IMU {gyro xyz, acc xyz float32}                 (24 B)
  (dual/triple-return types 4/6 are skipped with a warning; spherical
  angles are 0.01°, depth/coords are millimetres.)

Host-side on purpose — this is the I/O boundary, not the compute path.
"""
from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

MAGIC = 0xAC0EA767
SIGNATURE = b"livox_tech" + b"\x00" * 6

_PKG_HEADER = struct.Struct("<BBBBBIBBQ")   # 19 bytes

_DT0 = np.dtype([("x", "<i4"), ("y", "<i4"), ("z", "<i4"), ("r", "u1")])
_DT1 = np.dtype([("depth", "<u4"), ("theta", "<u2"), ("phi", "<u2"),
                 ("r", "u1")])
_DT2 = np.dtype([("x", "<i4"), ("y", "<i4"), ("z", "<i4"), ("r", "u1"),
                 ("tag", "u1")])
_DT3 = np.dtype([("depth", "<u4"), ("theta", "<u2"), ("phi", "<u2"),
                 ("r", "u1"), ("tag", "u1")])

# data_type → (point dtype, points per package) ; None = skip payload
_POINT_LAYOUT = {
    0: (_DT0, 100),
    1: (_DT1, 100),
    2: (_DT2, 96),
    3: (_DT3, 96),
    4: (None, 48 * 28 + 0),    # dual extend cartesian: 48×28 B payload
    5: (None, 24),             # IMU: 24 B payload
    6: (None, 30 * 42),        # triple extend cartesian (v1.3): skip
}
_PAYLOAD_BYTES = {0: 100 * 13, 1: 100 * 9, 2: 96 * 14, 3: 96 * 10,
                  4: 48 * 28, 5: 24, 6: 30 * 42}


@dataclass
class LvxPackage:
    device_index: int
    lidar_id: int
    data_type: int
    timestamp_ns: int
    xyz: np.ndarray            # (N, 3) float32, metres
    reflectivity: np.ndarray   # (N,) float32
    tag: Optional[np.ndarray]


def _spherical_to_xyz(depth_m, theta_cdeg, phi_cdeg):
    theta = np.deg2rad(theta_cdeg.astype(np.float64) * 0.01)  # zenith
    phi = np.deg2rad(phi_cdeg.astype(np.float64) * 0.01)      # azimuth
    st = np.sin(theta)
    return np.stack([depth_m * np.cos(theta),
                     depth_m * st * np.sin(phi),
                     depth_m * st * np.cos(phi)], axis=1).astype(np.float32)


class LvxReader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self._buf = f.read()
        buf = self._buf
        if len(buf) < 29 or buf[:10] != SIGNATURE[:10]:
            raise ValueError(f"{path}: not an lvx file (bad signature)")
        (magic,) = struct.unpack_from("<I", buf, 20)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad lvx magic 0x{magic:08x}")
        self.version = tuple(buf[16:20])
        self.frame_duration_ms, self.device_count = struct.unpack_from(
            "<IB", buf, 24)
        self._pkg_start = 29 + 59 * self.device_count
        self.device_info = buf[29: self._pkg_start]

    # -- low level: iterate packages ---------------------------------------
    def packages(self) -> Iterator[LvxPackage]:
        buf = self._buf
        pos = self._pkg_start
        n = len(buf)
        warned: set = set()
        while pos + 24 <= n:
            cur, nxt, _idx = struct.unpack_from("<QQQ", buf, pos)
            if cur != pos:   # tolerate writers recording absolute offsets
                if not (0 < nxt <= n and cur < nxt):
                    break
            frame_end = min(nxt if nxt > pos else n, n)
            p = pos + 24
            while p + _PKG_HEADER.size <= frame_end:
                (dev_idx, _ver, _slot, lidar_id, _rsvd, _status,
                 _ts_type, data_type, ts) = _PKG_HEADER.unpack_from(buf, p)
                p += _PKG_HEADER.size
                nbytes = _PAYLOAD_BYTES.get(data_type)
                if nbytes is None or p + nbytes > frame_end:
                    # unknown layout: cannot find the next package — skip
                    # to the next frame boundary
                    if data_type not in warned:
                        if nbytes is None:
                            warnings.warn(
                                f"lvx data_type {data_type} unknown; "
                                "skipping to next frame")
                        else:
                            warnings.warn(
                                f"lvx package (data_type {data_type}) "
                                "truncated; skipping to next frame")
                        warned.add(data_type)
                    break
                layout = _POINT_LAYOUT[data_type][0]
                if layout is not None:
                    pts = np.frombuffer(
                        buf, dtype=layout,
                        count=_POINT_LAYOUT[data_type][1], offset=p)
                    if data_type in (0, 2):
                        xyz = np.stack(
                            [pts["x"], pts["y"], pts["z"]],
                            axis=1).astype(np.float32) * 1e-3
                    else:
                        xyz = _spherical_to_xyz(
                            pts["depth"].astype(np.float64) * 1e-3,
                            pts["theta"], pts["phi"])
                    yield LvxPackage(
                        device_index=dev_idx, lidar_id=lidar_id,
                        data_type=data_type, timestamp_ns=ts,
                        xyz=xyz,
                        reflectivity=pts["r"].astype(np.float32),
                        tag=(np.ascontiguousarray(pts["tag"])
                             if "tag" in layout.names else None))
                p += nbytes
            pos = frame_end if frame_end > pos else n

    # -- high level: regroup into fixed-period point frames ------------------
    def frames(self, frame_period_s: float = 0.1, device_index: int = 0
               ) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        """Accumulate packages of one device into frames of
        ``frame_period_s`` (the reference's scanPeriod, 0.1 s —
        ``laser_feature_extractor.hpp:68``); lvx native frames are 50 ms.
        Yields (xyz, reflectivity, stamp_seconds)."""
        period_ns = int(frame_period_s * 1e9)
        cur_bin = None
        bufs: List[LvxPackage] = []
        for pkg in self.packages():
            if pkg.device_index != device_index:
                continue
            b = pkg.timestamp_ns // period_ns
            if cur_bin is None:
                cur_bin = b
            if b != cur_bin:
                if bufs:
                    yield self._emit(bufs, cur_bin * period_ns)
                bufs = []
                cur_bin = b
            bufs.append(pkg)
        if bufs and cur_bin is not None:
            yield self._emit(bufs, cur_bin * period_ns)

    @staticmethod
    def _emit(bufs, t0_ns):
        xyz = np.concatenate([p.xyz for p in bufs])
        refl = np.concatenate([p.reflectivity for p in bufs])
        return xyz, refl, t0_ns * 1e-9


class LvxWriter:
    """Writes data_type-2 (extended cartesian, 96-pt packages) captures —
    the Mid-40 standard output — for fixtures and converter round-trips."""

    def __init__(self, path: str, frame_duration_ms: int = 50):
        self._f = open(path, "wb")
        self._f.write(SIGNATURE)
        self._f.write(bytes([1, 1, 0, 0]))
        self._f.write(struct.pack("<I", MAGIC))
        self._f.write(struct.pack("<IB", frame_duration_ms, 1))
        self._f.write(b"\x00" * 59)              # one blank device info
        self._frame_duration_ns = frame_duration_ms * 10**6
        self._packages: List[bytes] = []
        self._pkg_times: List[int] = []
        self._closed = False

    def add_points(self, xyz: np.ndarray, reflectivity: np.ndarray,
                   timestamp_ns: int) -> None:
        """Split one point batch into 96-pt packages (zero-padded tail
        points carry depth 0 → masked by the front-end's e_pt_000)."""
        xyz = np.asarray(xyz, np.float64)
        n = len(xyz)
        per = 96
        for s in range(0, max(n, 1), per):
            pts = np.zeros(per, dtype=_DT2)
            chunk = xyz[s: s + per]
            m = len(chunk)
            pts["x"][:m] = np.round(chunk[:, 0] * 1e3)
            pts["y"][:m] = np.round(chunk[:, 1] * 1e3)
            pts["z"][:m] = np.round(chunk[:, 2] * 1e3)
            pts["r"][:m] = np.clip(reflectivity[s: s + m], 0, 255)
            # per-point spacing 10 µs ⇒ 960 µs per package
            ts = timestamp_ns + s * 10_000
            header = _PKG_HEADER.pack(0, 5, 1, 1, 0, 0, 1, 2, ts)
            self._packages.append(header + pts.tobytes())
            self._pkg_times.append(ts)

    def close(self) -> None:
        if self._closed:
            return
        # group packages into 50 ms frames with correct offset links
        groups: List[List[int]] = []
        cur_bin = None
        for i, ts in enumerate(self._pkg_times):
            b = ts // self._frame_duration_ns
            if cur_bin is None or b != cur_bin:
                groups.append([])
                cur_bin = b
            groups[-1].append(i)
        pos = self._f.tell()
        for fi, g in enumerate(groups):
            body = b"".join(self._packages[i] for i in g)
            nxt = pos + 24 + len(body)
            self._f.write(struct.pack("<QQQ", pos, nxt, fi))
            self._f.write(body)
            pos = nxt
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
