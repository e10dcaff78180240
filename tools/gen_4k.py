#!/usr/bin/env python3
"""Synthesize the 4K spot-check fixture (bench_data/test4k.m1v):
8 frames of 3840x2160 MPEG-1 via libavcodec (cv2, PIM1 fourcc), ES
extracted from the AVI container.  Used by
tests/test_batch.py::test_batch_decoder_4k_matches_host_decoder —
a spot-run geometry check (the cold 4K compile is minutes), skipped
when the fixture is absent."""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "bench_data", "test4k.m1v")


def main():
    import cv2

    if os.path.exists(OUT):
        print(f"exists: {OUT}")
        return
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    w, h, n = 3840, 2160, 8
    avi = OUT + ".tmp.avi"
    vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"PIM1"), 30, (w, h))
    rng = np.random.default_rng(5)
    base = rng.integers(30, 220, (h // 128, w // 128, 3), np.uint8)
    base = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    base = cv2.GaussianBlur(base, (31, 31), 10)
    for i in range(n):
        m = np.float32([[1, 0, 3 * i], [0, 1, 2 * i]])
        f = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_WRAP)
        cv2.circle(f, (400 + 60 * i, 700 + 40 * i), 150, (200, 80, 40), -1)
        vw.write(f)
    vw.release()

    from gen_1080 import avi_video_es
    out = avi_video_es(open(avi, "rb").read())
    open(OUT, "wb").write(out)
    os.remove(avi)
    print(f"wrote {OUT} ({len(out)} bytes, {n} frames)")


if __name__ == "__main__":
    main()
