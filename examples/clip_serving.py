#!/usr/bin/env python3
"""Serving-style parallel clip extraction: decode K clips of one .mpg
from different timestamps simultaneously, one clip per mesh device.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python examples/clip_serving.py [file.mpg t1 t2 ...]

Composes the framework's serving pieces: deterministic intra-targeted
clip extraction (BatchVideoDecoder.at_time builds the clip bytes), the
fully-native PS pipeline per clip, and stream-DP over the device mesh
(window-pool blobs under shard_map).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from mpeg_tpu.parallel import BatchVideoDecoder
from mpeg_tpu.parallel import sharding as sh
from mpeg_tpu.parallel.batch import blob_views, blob_layout


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    args = sys.argv[1:]
    path = args[0] if args else os.path.join(
        os.path.dirname(__file__), "..", "tests", "testdata", "test.mpg")
    times = [float(t) for t in args[1:]] or [0.0, 2.5, 5.0, 7.5]
    data = open(path, "rb").read()

    n = min(len(times), len(jax.devices()))
    times = times[:n]
    decs = []
    for t in times:
        got = BatchVideoDecoder.at_time(data, t, window=8)
        assert got is not None, f"no intra frame at/before t={t}"
        dec, pts = got
        decs.append(dec)
        print(f"clip @ {t:5.1f}s -> intra packet pts {pts:.3f}")

    geom = decs[0].geom
    window = 8

    # One window per clip, all extracted through the native pipeline,
    # stacked and decoded in ONE sharded dispatch.
    blobs = []
    km = ke = 0
    for dec in decs:
        blob, _types, _fill = dec._native_window_blob()
        km, ke = max(km, dec._km), max(ke, dec._ke)
        blobs.append((blob, dec._km, dec._ke))

    # Re-layout every clip's blob to the common capacity buckets.
    _, total = blob_layout(geom, window, km, ke)
    stacked = np.zeros((n, total), np.uint8)
    for s, (blob, bkm, bke) in enumerate(blobs):
        src = blob_views(blob, geom, window, bkm, bke)
        dst = blob_views(stacked[s], geom, window, km, ke)
        for k in src:
            dst[k][:src[k].size] = src[k]

    mesh = sh.make_mesh(jax.devices()[:n])
    decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
    carry = sh.zero_carry(geom, n, mesh)
    carry, disps, px = decode(carry, stacked)
    disps = np.asarray(disps)
    print(f"mesh: decoded {int(px):,} px across {n} devices in one "
          f"dispatch; first window of each clip is on its device")
    for s, t in enumerate(times):
        y = disps[s, -1, :geom.luma_size]
        print(f"  clip @ {t:.1f}s window[-1] luma mean {y.mean():.1f}")


if __name__ == "__main__":
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
