#!/usr/bin/env python3
"""Multi-stream decode sharded over a device mesh.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/multistream_mesh.py

Each device scans its own stream's picture plans; the only collective is
a psum'd decoded-pixel stat (streams are embarrassingly parallel).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import mpeg_tpu as mpeg
from mpeg_tpu.parallel import sharding as sh


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # Some environments force a platform at interpreter start; the
        # config update makes the env-var request stick.
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    n = len(devices)
    print(f"mesh: {n} x {devices[0].platform}")

    path = os.path.join(os.path.dirname(__file__), "..",
                        "tests", "testdata", "test.mpeg1video")

    videos = []
    for _ in range(n):
        buf = mpeg.Buffer(open(path, "rb"))
        buf.set_load_callback(buf.load_reader_callback)
        videos.append(mpeg.Video(buf, backend="plan"))
    assert all(v.has_header() for v in videos)
    geom = videos[0].geom

    from mpeg_tpu.parallel.batch import count_pool_records, pool_bucket

    mesh = sh.make_mesh(devices)
    carry = sh.zero_carry(geom, n, mesh)

    window = 8
    km, ke = 4096, 64   # sticky pool buckets (grow on demand)
    decode = None
    total_frames = 0
    while True:
        per_stream = []
        for v in videos:
            plans = []
            while len(plans) < window and \
                    (item := v.parse_next_plan()) is not None:
                plans.append(item)
            per_stream.append(plans)
        if not any(per_stream):
            break
        nm = max(count_pool_records(p)[0] for p in per_stream)
        ne = max(count_pool_records(p)[1] for p in per_stream)
        if pool_bucket(nm, km) != km or pool_bucket(max(ne, 1), ke) != ke \
                or decode is None:
            km, ke = pool_bucket(nm, km), pool_bucket(max(ne, 1), ke)
            decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
        blobs = sh.stack_stream_blobs(per_stream, geom, window, km, ke)
        carry, disps, px = decode(carry, blobs)
        total_frames += sum(len(p) for p in per_stream)
        print(f"window: decoded {int(px):>12,} px across the mesh "
              f"({blobs.nbytes / 1e6:.2f} MB h2d)")

    print(f"total: {total_frames} pictures over {n} streams")


if __name__ == "__main__":
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
