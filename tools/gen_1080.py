#!/usr/bin/env python3
"""Synthesize the committed 1080p fixture (tests/testdata/test1080.m1v):
32 frames of 1920x1080 MPEG-1 via libavcodec (cv2, PIM1 fourcc), seed 7,
the elementary stream extracted from the AVI container.

Typical-video content: a smooth panning background plus six moving
discs (worst-case noise content would only measure the encoder's
maximum bitrate).  chip_smoke.py and bench.py read the committed file;
only this generator needs cv2.

Usage: python tools/gen_1080.py [--force]
"""

import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "testdata", "test1080.m1v")
WIDTH, HEIGHT, FRAMES, SEED = 1920, 1080, 32, 7


def avi_video_es(data: bytes) -> bytes:
    """Concatenate the video chunks (`??dc`) of an AVI file."""
    out = bytearray()

    def walk(pos, end):
        while pos + 8 <= end:
            fid = data[pos:pos + 4]
            size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
            if fid in (b"RIFF", b"LIST"):
                walk(pos + 12, pos + 8 + size)
            elif fid.endswith(b"dc"):
                out.extend(data[pos + 8:pos + 8 + size])
            pos += 8 + size + (size & 1)

    walk(12, len(data))
    return bytes(out)


def main():
    import cv2

    if os.path.exists(OUT) and "--force" not in sys.argv:
        print(f"exists: {OUT}")
        return
    avi = OUT + ".tmp.avi"
    w = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"PIM1"), 30,
                        (WIDTH, HEIGHT))
    rng = np.random.default_rng(SEED)
    base = rng.integers(40, 200, (HEIGHT // 128, WIDTH // 128, 3), np.uint8)
    base = cv2.resize(base, (WIDTH, HEIGHT), interpolation=cv2.INTER_CUBIC)
    base = cv2.GaussianBlur(base, (31, 31), 12)
    for i in range(FRAMES):
        m = np.float32([[1, 0, 2 * i], [0, 1, i]])
        frame = cv2.warpAffine(base, m, (WIDTH, HEIGHT),
                               borderMode=cv2.BORDER_WRAP)
        for obj in range(6):
            x = int((obj * 293 + i * (7 + obj)) % (WIDTH - 160))
            y = int((obj * 177 + i * (3 + obj)) % (HEIGHT - 160))
            cv2.circle(frame, (x + 80, y + 80), 60,
                       (int(40 * obj) % 255, 200, 90), -1)
        w.write(frame)
    w.release()
    es = avi_video_es(open(avi, "rb").read())
    os.remove(avi)
    open(OUT, "wb").write(es)
    print(f"wrote {OUT} ({len(es)} bytes, {FRAMES} frames)")


if __name__ == "__main__":
    main()
