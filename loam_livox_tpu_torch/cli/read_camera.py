"""Camera/image-stream debug utility — the analogue of the reference's

The counterpart of ``loam_livox_tpu/cli/read_camera.py`` (host only;
no torch, no JAX).
`read_camera` node (``source/read_camera.cpp:8-47``: open a webcam,
grab frames in a loop, stamp and publish them on an image topic for
side-by-side visualization; not part of the SLAM path).

Without ROS the "topic" becomes an output directory of timestamped
frames (or a Python generator for in-process consumers).  Sources:

* ``--source dir:<path>``  replay an image directory in name order at
                           ``--fps`` (the no-hardware debug path),
* ``--source cam:<idx>``   live webcam via OpenCV, if cv2 is importable
                           (gated — cv2 is not a framework dependency).

Usage:
    python -m loam_livox_tpu_torch.cli.read_camera --source dir:imgs --out caps
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Iterator, Tuple

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".npy")


def camera_stream(source: str, fps: float = 10.0
                  ) -> Iterator[Tuple[float, str, object]]:
    """Yield (timestamp, name, frame) — `frame` is a path for dir
    sources, an ndarray for cam sources.  Paced at `fps` like the
    reference's capture loop (read_camera.cpp:27-44 grabs + publishes
    per iteration)."""
    period = 1.0 / max(fps, 1e-3)
    if source.startswith("dir:"):
        d = source[4:]
        names = sorted(f for f in os.listdir(d)
                       if f.lower().endswith(IMG_EXTS))
        if not names:
            raise SystemExit(f"no images in {d!r}")
        for name in names:
            yield time.time(), name, os.path.join(d, name)
            time.sleep(period)
    elif source.startswith("cam:"):
        try:
            import cv2  # type: ignore
        except ImportError:
            raise SystemExit(
                "cam: source needs OpenCV (cv2), which is not installed; "
                "use dir:<path> for the replay debug path")
        cap = cv2.VideoCapture(int(source[4:]))
        if not cap.isOpened():
            raise SystemExit(f"cannot open camera {source[4:]}")
        i = 0
        try:
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield time.time(), f"cam_{i:06d}.png", frame
                i += 1
                time.sleep(period)
        finally:
            cap.release()
    else:
        raise SystemExit(f"unknown source {source!r} (dir:<path>|cam:<idx>)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--source", required=True, help="dir:<path> | cam:<idx>")
    p.add_argument("--out", default=None,
                   help="output directory of timestamped frames "
                        "(the 'topic'); omit to just log")
    p.add_argument("--fps", type=float, default=10.0)
    p.add_argument("--frames", type=int, default=0, help="0 = unbounded")
    args = p.parse_args(argv)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    n = 0
    for stamp, name, frame in camera_stream(args.source, args.fps):
        if args.out:
            dst = os.path.join(args.out, f"{stamp:.6f}_{name}")
            if isinstance(frame, str):
                shutil.copyfile(frame, dst)
            else:  # ndarray from cam
                import cv2  # type: ignore

                cv2.imwrite(dst, frame)
        print(f"frame {n}: {stamp:.6f} {name}", file=sys.stderr)
        n += 1
        if args.frames and n >= args.frames:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
