#!/usr/bin/env python3
"""Throughput decode: a raw mpeg1video ES — or a whole .mpg program
stream — through the windowed scan path.

Usage: python examples/batch_decode.py [file.m1v | file.mpg]

One device dispatch reconstructs a whole window of pictures (native C++
demux+parse feeding window-pool blobs); frames stay on device — here we
pull stats, one thumbnail and (for the PS demo) fused RGBA output back.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import mpeg_tpu as mpeg
from mpeg_tpu.parallel import BatchAudioDecoder, BatchVideoDecoder


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "..",
                     "tests", "testdata", "test.mpeg1video")
    data = open(path, "rb").read()

    dec = BatchVideoDecoder(data, window=32)
    t0 = time.time()
    frames = dec.decode_all()
    dt = time.time() - t0
    geom = dec.geom
    print(f"{geom.width}x{geom.height}: {len(frames)} frames in {dt:.2f}s "
          f"({len(frames)/dt:.1f} fps incl. compile)")

    last = np.asarray(frames[-1])
    y = last[:geom.luma_size].reshape(geom.luma_height, geom.luma_width)
    print(f"last frame luma mean {y.mean():.1f}")

    if bytes(data[:4]) == b"\x00\x00\x01\xBA":
        # Program stream: audio rides the same fully-native pipeline,
        # and video can come back as fused on-device RGBA.
        adec = BatchAudioDecoder(data)
        pcm = adec.decode_all()
        rate = adec.samplerate
        if rate:
            print(f"audio: {pcm.size // 2} samples "
                  f"({pcm.size / 2 / rate:.1f}s)")
        else:
            print("audio: no audio stream")
        rgba = BatchVideoDecoder(data, window=32, emit_rgba=True)
        first = np.asarray(rgba.decode_window()[0])
        print(f"RGBA output: {first.shape} "
              f"mean=({first[..., 0].mean():.0f}, "
              f"{first[..., 1].mean():.0f}, {first[..., 2].mean():.0f})")


if __name__ == "__main__":
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
