#!/usr/bin/env python3
"""Production-shaped A/V serving: decode a .mpg program stream with
EVERYTHING device-resident — video frames as fused RGBA and audio PCM
as device-quantized S16 — so downstream device consumers (overlays,
encoders, mixers) read straight from device memory and the serve loop never
blocks on device-to-host transfers.

Usage: python examples/av_serving.py [file.mpg]

The two decoders share the fully-native C++ PS pipeline (demux + both
ES parsers, zero per-packet Python); the video decoder overlaps its
parse thread with device dispatch (prefetch=True).
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from mpeg_tpu.parallel import BatchAudioDecoder, BatchVideoDecoder


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "..",
                     "tests", "testdata", "test.mpg")
    data = open(path, "rb").read()

    video = BatchVideoDecoder(data, window=16, emit_rgba=True,
                              prefetch=True)
    audio = BatchAudioDecoder(data, window=64, out_format="s16",
                              out_device=True)

    import jax

    t0 = time.time()
    frames = 0
    last_frame = None
    while got := video.decode_window():
        frames += len(got)
        last_frame = got[-1]          # [H, W, 4] uint8, device-resident
    samples = 0
    last_pcm = None
    while (pcm := audio.decode_window()) is not None:
        samples += pcm.size // 2      # int16 interleaved, device-resident
        last_pcm = pcm
    jax.block_until_ready([x for x in (last_frame, last_pcm)
                           if x is not None])
    dt = time.time() - t0

    print(f"{frames} RGBA frames + {samples} stereo samples decoded "
          f"in {dt:.2f}s — all output device-resident "
          f"(platform: {jax.devices()[0].platform})")
    # Only the demo pulls anything to host: one thumbnail + peak level.
    # (Either substream may be absent in a user-supplied file.)
    if last_frame is not None:
        thumb = np.asarray(last_frame)[::16, ::16, :3]
        print(f"last frame thumbnail {thumb.shape}, mean RGB "
              f"{thumb.reshape(-1, 3).mean(axis=0).round(1)}")
    if last_pcm is not None:
        peak = float(np.abs(np.asarray(last_pcm)).max()) / 0x7FFF
        print(f"audio peak {peak:.3f}")


if __name__ == "__main__":
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
