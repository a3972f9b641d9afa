"""The port's input sources against the JAX package's, on the CPU: the
bag and ``.lvx`` readers and writers (copies of the JAX modules), the
native PCD decoder and prefetch queue, and `runtime.sync.FrameAssembler`.

* The committed fixture bag (``tests/fixtures/sim_livox.bag``, Livox
  CustomMsg in bz2 chunks) decodes to equal arrays and stamps in both.
* Bags (none / bz2 chunks, PointCloud2 and CustomMsg topics) and
  ``.lvx`` files written by either package are byte-equal and are read
  by the other with equal arrays.
* The native library (``native/native_io.cpp``, built into the port's
  ``_build/``) decodes PCD files to exactly the arrays of its plain
  Python version and the JAX package's reader; its queue streams every
  frame in order and, past its capacity, drops the oldest, as the plain
  queue does.
* `FrameAssembler`: the cases of the JAX package's tests/test_sync.py.
"""
import glob
import os
import time

import numpy as np
import pytest

from loam_livox_tpu.io import lvx as jlvx
from loam_livox_tpu.io import rosbag as jbag
from loam_livox_tpu.io import serialization as jser

from loam_livox_tpu_torch.io import lvx as tlvx
from loam_livox_tpu_torch.io import native
from loam_livox_tpu_torch.io import rosbag as tbag
from loam_livox_tpu_torch.io.serialization import save_pcd
from loam_livox_tpu_torch.runtime.sync import FrameAssembler

BAG = os.path.join(os.path.dirname(__file__), "fixtures", "sim_livox.bag")


def cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) * 5.0,
            rng.uniform(0, 200, size=n).astype(np.float32))


def assert_streams_equal(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for (xa, ia, ta), (xb, ib, tb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ia, ib)
        assert ta == tb


def test_fixture_bag_decodes_alike():
    port = list(tbag.bag_frame_stream(BAG))
    assert len(port) == 24 and port[0][0].dtype == np.float32
    assert_streams_equal(port, jbag.bag_frame_stream(BAG))
    assert tbag.BagReader(BAG).topics() == jbag.BagReader(BAG).topics()


def write_bag(mod, path, compression):
    with mod.BagWriter(path, compression=compression) as w:
        for i in range(4):
            xyz, inten = cloud(96, seed=i)
            t = 100.0 + 0.1 * i
            w.write("/livox/lidar", "livox_ros_driver/CustomMsg", t,
                    mod.encode_livox_custommsg(t, xyz, inten))
            w.write("/velodyne", "sensor_msgs/PointCloud2", t,
                    mod.encode_pointcloud2(t, xyz, inten))
            if i == 1:
                w.flush()      # a second chunk
        w.write("/tf", "tf2_msgs/TFMessage", 0.0, b"\x00" * 8)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bags_cross_between_packages(tmp_path, compression):
    pj, pt = str(tmp_path / "jax.bag"), str(tmp_path / "port.bag")
    write_bag(jbag, pj, compression)
    write_bag(tbag, pt, compression)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for topic in ("/livox/lidar", "/velodyne"):
        assert_streams_equal(tbag.bag_frame_stream(pj, topic), jbag.bag_frame_stream(pt, topic))
    assert_streams_equal(tbag.bag_frame_stream(pj), jbag.bag_frame_stream(pj))
    raw = tbag.encode_livox_custommsg(5.0, *cloud(10))
    assert raw == jbag.encode_livox_custommsg(5.0, *cloud(10))
    a, b = tbag.decode_livox_custommsg(raw), jbag.decode_livox_custommsg(raw)
    for f in ("xyz", "reflectivity", "offset_time_ns", "tag", "line"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def write_lvx(mod, path):
    rng = np.random.default_rng(3)
    with mod.LvxWriter(path) as w:
        for i in range(3):
            w.add_points(rng.uniform(1.0, 20.0, size=(960, 3)), rng.uniform(0, 200, size=960),
                         timestamp_ns=int(i * 1e8))


def test_lvx_files_cross_between_packages(tmp_path):
    pj, pt = str(tmp_path / "jax.lvx"), str(tmp_path / "port.lvx")
    write_lvx(jlvx, pj)
    write_lvx(tlvx, pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for a, b in ((tlvx.LvxReader(pj), jlvx.LvxReader(pt)),):
        assert a.device_count == b.device_count == 1
        assert_streams_equal(a.frames(frame_period_s=0.1), b.frames(frame_period_s=0.1))


# ------------------------------------------------------------- native --

@pytest.fixture
def pcd_dir(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(6):
        xyz = rng.normal(size=(50 + i, 3)).astype(np.float32)
        inten = rng.uniform(size=50 + i).astype(np.float32)
        save_pcd(str(tmp_path / f"{i:04d}.pcd"), xyz, inten, binary=(i % 2 == 0))
    return str(tmp_path)


def test_native_library_builds_into_the_port():
    path = native.build()
    assert path.parent == native.BUILD and path.exists()
    assert path.name.startswith("_native_io-")
    assert os.path.dirname(native.load().__file__) == str(native.BUILD)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
def test_native_decode_equals_plain(tmp_path, binary):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(123, 3)).astype(np.float32)
    inten = rng.uniform(size=123).astype(np.float32)
    p = str(tmp_path / "c.pcd")
    save_pcd(p, xyz, inten, binary=binary)
    nx, ni = native.decode_pcd_file(p)
    px, pi = native.plain_decode_pcd_file(p)
    jx, ji = jser.load_pcd(p)
    for got in ((nx, ni), (jx, ji)):
        np.testing.assert_array_equal(got[0], px)
        np.testing.assert_array_equal(got[1], pi)
    bx, bi = native.decode_pcd(open(p, "rb").read())
    np.testing.assert_array_equal(bx, px)
    with pytest.raises(ValueError):
        native.decode_pcd(b"not a pcd\nDATA binary\n")


@pytest.mark.parametrize("make", [native.make_frame_queue, native.PlainFrameQueue],
                         ids=["native", "plain"])
def test_queue_streams_in_order_and_drops_the_oldest(pcd_dir, make):
    files = sorted(glob.glob(os.path.join(pcd_dir, "*.pcd")))
    q = make(files, 64)
    frames = []
    while (item := q.next_frame()) is not None:
        frames.append(item)
    assert [len(x) for x, _ in frames] == [50 + i for i in range(6)] and q.dropped() == 0
    for (x, i), f in zip(frames, files):
        px, pi = native.plain_decode_pcd_file(f)
        np.testing.assert_array_equal(x, px)
        np.testing.assert_array_equal(i, pi)
    q = make(files, 2)
    time.sleep(0.5)             # the producer outruns the consumer
    got = []
    while (item := q.next_frame()) is not None:
        got.append(len(item[0]))
    assert len(got) + q.dropped() == 6 and q.dropped() >= 1
    assert got == sorted(got) and got[-1] == 55      # the newest survive, in order


def test_pcd_dir_stream(pcd_dir):
    assert [len(x) for x, _ in native.pcd_dir_stream(pcd_dir)] == [50 + i for i in range(6)]


# -------------------------------------------------------- the assembler --

def test_assembler_joins_on_all_three():
    fa = FrameAssembler()
    xyz = np.zeros((4, 3), np.float32)
    fa.add(fa.CORNER, 1.0, xyz)
    fa.add(fa.SURFACE, 1.0, xyz)
    assert fa.pop() is None and fa.pending_count() == 1
    fa.add(fa.FULL, 1.0, xyz)
    stamp, parts = fa.pop()
    assert stamp == 1.0 and set(parts) == {"corner", "surface", "full"}


def test_assembler_out_of_order_stamps():
    fa = FrameAssembler()
    xyz = np.zeros((2, 3), np.float32)
    for s in (2.0, 1.0):
        for k in (fa.CORNER, fa.SURFACE, fa.FULL):
            fa.add(k, s, xyz)
    assert fa.pop()[0] == 2.0     # completion order
    assert fa.pop()[0] == 1.0


def test_assembler_drops_the_oldest():
    from loam_livox_tpu_torch.core.config import SlamConfig

    fa = FrameAssembler.from_config(SlamConfig().replace(mapping={"maximum_mapping_buffer": 2}))
    xyz = np.zeros((1, 3), np.float32)
    for s in (1.0, 2.0, 3.0, 4.0):
        for k in (fa.CORNER, fa.SURFACE, fa.FULL):
            fa.add(k, s, xyz)
    assert fa.dropped == 2 and fa.max_buffer == 2
    assert fa.pop()[0] == 3.0
