#!/usr/bin/env python3
"""Clock-driven playback: decode an MPEG-PS file with synced A/V callbacks.

Usage: python examples/play.py [file.mpg] [out_dir]

Mirrors the reference's intended usage (mpeg.go:6-16): set callbacks, then
feed wall-clock ticks to decode(); frames/samples arrive through the
callbacks.  Writes a few frames as PPM images and the PCM as raw f32.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import mpeg_tpu as mpeg


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(os.path.dirname(__file__), "..",
                     "tests", "testdata", "test.mpg")
    out_dir = sys.argv[2] if len(sys.argv) > 2 else "/tmp/mpeg_tpu_play"
    os.makedirs(out_dir, exist_ok=True)

    m = mpeg.MPEG(open(path, "rb"))
    print(f"{m.width()}x{m.height()} @ {m.framerate():.3f} fps, "
          f"{m.samplerate()} Hz x{m.channels()}, "
          f"duration {m.duration():.2f}s")

    frames = [0]
    pcm = []

    def on_video(_m, frame):
        if frames[0] % 60 == 0:
            rgba = frame.rgba()
            p = os.path.join(out_dir, f"frame{frames[0]:05d}.ppm")
            with open(p, "wb") as f:
                f.write(b"P6\n%d %d\n255\n" % (frame.width, frame.height))
                f.write(rgba[:, :, :3].tobytes())
        frames[0] += 1

    def on_audio(_m, samples):
        pcm.append(samples.interleaved.copy())

    m.set_video_callback(on_video)
    m.set_audio_callback(on_audio)
    m.set_audio_lead_time(0.1)

    tick = 1.0 / max(m.framerate(), 1)
    while not m.has_ended():
        m.decode(tick)

    np.concatenate(pcm).tofile(os.path.join(out_dir, "audio_f32le.raw"))
    print(f"decoded {frames[0]} frames, {len(pcm)} audio frames "
          f"-> {out_dir}")


if __name__ == "__main__":
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
