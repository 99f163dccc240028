"""Probe the host's video I/O: what the port's video and camera paths need.

    python3 tools/video_io_probe.py [--frames 8] [--out DIR]

Prints cv2's version and the "Video I/O" lines of its build information,
writes ``--frames`` 1080p frames with ``cv2.VideoWriter`` (mp4v, 25 fps),
reads them back with ``cv2.VideoCapture`` (the frame count it reports, its
backend, the frames read), asks whether camera 0 opens, and prints the
card's name and power limit when ``nvidia-smi`` is there. The last line is
one JSON object of the answers; the exit code is 1 when mp4v does not
round-trip every frame.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np


def _video_io_lines(info: str) -> list[str]:
    lines = info.splitlines()
    for i, line in enumerate(lines):
        if line.strip().startswith("Video I/O"):
            out = [line.rstrip()]
            for nxt in lines[i + 1:]:
                if nxt.strip() and not nxt.startswith("    "):
                    break
                if nxt.strip():
                    out.append(nxt.rstrip())
            return out
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default=None,
                    help="directory for the probe video (default: a "
                         "temporary one, removed after)")
    args = ap.parse_args(argv)

    import cv2

    result: dict = {"cv2": cv2.__version__}
    io_lines = _video_io_lines(cv2.getBuildInformation())
    print("\n".join(io_lines))
    result["video_io"] = [" ".join(line.split()) for line in io_lines]

    tmp = args.out or tempfile.mkdtemp()
    path = os.path.join(tmp, "probe.mp4")
    try:
        rng = np.random.default_rng(0)
        base = rng.integers(0, 256, (1080, 1920, 3), np.uint8)
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                             (1920, 1080))
        result["writer_opened"] = bool(vw.isOpened())
        written = 0
        if vw.isOpened():
            for i in range(args.frames):
                vw.write(np.roll(base, 8 * i, axis=1))
                written += 1
        vw.release()
        result["written"] = written
        result["bytes"] = os.path.getsize(path) if os.path.exists(path) \
            else 0
        cap = cv2.VideoCapture(path)
        result["capture_opened"] = bool(cap.isOpened())
        result["frame_count"] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        result["backend"] = cap.getBackendName() if cap.isOpened() else None
        read = 0
        shape = None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            read += 1
            shape = list(frame.shape)
        cap.release()
        result["read"] = read
        result["frame_shape"] = shape
    finally:
        if args.out is None:
            shutil.rmtree(tmp, ignore_errors=True)

    cam = cv2.VideoCapture(0)
    result["camera0_opened"] = bool(cam.isOpened())
    cam.release()

    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        result["gpu"] = smi.stdout.strip()
    print(json.dumps(result))
    ok = result["written"] == args.frames and result["read"] == args.frames
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
