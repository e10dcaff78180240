#!/usr/bin/env python3
"""Prove that the decoder's main path runs, bit-exact, on one NVIDIA GPU.

Usage (from the repository root, on a machine with a card):

  python chip_smoke.py               # every one-card phase below
  python chip_smoke.py --four-cards  # only the 4-card mesh path

One process drives the card through the library's own entry points:

1. video goldens: BatchVideoDecoder(window=16) and Video(backend="jax")
   reproduce 0xEA6D7FCB1340BA3F on tests/testdata/test.mpeg1video, and a
   clock-driven MPEG A/V decode of test.mpg on the device has the same
   video and audio digests as the host oracle (backend="numpy");
2. audio lanes: BatchAudioDecoder (f32) reproduces 0xF1B76CDF8E6CDEA5,
   and the device S16 lane (out_device=True) equals the host S16 lane;
3. 1080p, one stream: BatchVideoDecoder(window=16) on the committed
   1920x1080 stream (tests/testdata/test1080.m1v) is byte-equal to the
   C++ host decoder, frame by frame;
4. 1080p, four streams: MultiStreamVideoDecoder(window=2) over four
   staggered copies of that stream, each byte-equal to the host decoder;
5. reconstruct timing: the XLA reconstruct of one 1080p picture, ms per
   picture over a warmed loop, beside its memory floor;
6. the `gpu`-marked tests (tests/test_gpu.py), run in this process.

`--four-cards` runs only the mesh path (parallel/sharding.py) over four
cards: each card decodes its own copy of the fixture stream (golden on
every device) and of the 1080p stream, each compared with the one-card
decode, plus the sharded MP2 synthesis (audio golden on every device).

Each phase prints its seconds, XLA compile seconds and the device's
peak_bytes_in_use so far.  Any fault exits non-zero; so does a process
that finds no GPU (there is no CPU fallback).  The last line of stdout
is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
TESTDATA = os.path.join(REPO, "tests", "testdata")
sys.path.insert(0, REPO)

GOLDEN_VIDEO = 0xEA6D7FCB1340BA3F   # mpeg_test.go:227
GOLDEN_AUDIO = 0xF1B76CDF8E6CDEA5   # mpeg_test.go:193, no-FMA regime
H100_HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet

_COMPILE = {"seconds": 0.0, "count": 0}


def _on_duration(event, duration, *args, **kwargs):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE["seconds"] += duration
        _COMPILE["count"] += 1


def _read(name):
    with open(os.path.join(TESTDATA, name), "rb") as f:
        return f.read()


def _fnv(chunks):
    from mpeg_tpu.utils import Fnv1a64
    h = Fnv1a64()
    for c in chunks:
        h.write(c)
    return h.sum64()


def _check(cond, what):
    if not cond:
        raise AssertionError(what)


# -- phase bodies: plain functions of the fixtures, runnable on any backend --

def video_batch_golden(data=None, window=16):
    """Golden hash through BatchVideoDecoder (native parse, blob scan)."""
    import numpy as np
    from mpeg_tpu.parallel import BatchVideoDecoder

    dec = BatchVideoDecoder(data or _read("test.mpeg1video"), window=window)
    frames = []
    while got := dec.decode_window():
        frames += [np.asarray(f)[:dec.geom.frame_size].tobytes()
                   for f in got]
    h = _fnv(frames)
    _check(h == GOLDEN_VIDEO, f"BatchVideoDecoder hash {h:#018x}")
    return f"{len(frames)} frames, golden {h:#018x}"


def video_interactive_golden():
    """Golden hash through Video(backend="jax"), one dispatch/picture."""
    import io
    import mpeg_tpu as mpeg

    buf = mpeg.Buffer(io.BytesIO(_read("test.mpeg1video")))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="jax")
    chunks = []
    n = 0
    while (f := video.decode()) is not None:
        chunks += [f.y.tobytes(), f.cb.tobytes(), f.cr.tobytes()]
        n += 1
    h = _fnv(chunks)
    _check(h == GOLDEN_VIDEO, f"Video(backend='jax') hash {h:#018x}")
    return f"{n} frames, golden {h:#018x}"


def mpeg_digest(backend):
    """Clock-driven A/V decode of test.mpg (as tests/test_mpeg.py's
    _full_decode_digest): (video hash, audio hash, frames, frames)."""
    import mpeg_tpu as mpeg

    m = mpeg.MPEG(_read("test.mpg"), config=mpeg.Config(backend=backend))
    vid, aud = [], []
    m.set_video_callback(lambda _m, f: vid.extend(
        (f.y.tobytes(), f.cb.tobytes(), f.cr.tobytes())))
    m.set_audio_callback(lambda _m, s: aud.append(
        s.interleaved.astype("<f4").tobytes()))
    steps = 0
    while not m.done:
        m.decode(1.0 / 30.0)
        steps += 1
        _check(steps < 5000, "MPEG decode loop did not terminate")
    return _fnv(vid), _fnv(aud), len(vid) // 3, len(aud)


def mpeg_av_parity():
    """MPEG on the device equals MPEG on the host oracle."""
    dev, host = mpeg_digest("jax"), mpeg_digest("numpy")
    _check(dev == host and dev[2] > 0 and dev[3] > 0,
           f"MPEG device {dev} != host {host}")
    return (f"{dev[2]} video / {dev[3]} audio frames, digests "
            f"{dev[0]:#018x} / {dev[1]:#018x} equal the host oracle")


def audio_f32_golden():
    """Golden hash through BatchAudioDecoder's f32 lane."""
    import numpy as np
    from mpeg_tpu.parallel import BatchAudioDecoder

    pcm = BatchAudioDecoder(_read("test.mp2"), window=32).decode_all()
    h = _fnv([np.asarray(pcm).astype("<f4").tobytes()])
    _check(h == GOLDEN_AUDIO, f"BatchAudioDecoder f32 hash {h:#018x}")
    return f"{pcm.size} samples, golden {h:#018x}"


def audio_s16_parity():
    """Device-quantized S16 (out_device=True) equals the host S16 lane:
    trunc(s * 0x8000 | 0x7FFF) of the exact f32 PCM (audio.go:401-407)."""
    import numpy as np
    from mpeg_tpu.parallel import BatchAudioDecoder

    data = _read("test.mp2")
    f32 = BatchAudioDecoder(data, window=32).decode_all()
    host = np.trunc(np.where(f32 < 0, f32 * np.float32(0x8000),
                             f32 * np.float32(0x7FFF))).astype(np.int16)
    dev = BatchAudioDecoder(data, window=32, out_format="s16",
                            out_device=True).decode_all()
    dev = np.asarray(dev)
    _check(dev.dtype == np.int16 and np.array_equal(dev, host),
           "device S16 lane differs from the host S16 lane")
    return f"{dev.size} S16 samples equal the host lane"


def host_frames(data):
    """Every display frame of `data` from the C++ host decoder."""
    from mpeg_tpu import native
    dec = native.NativeHostDecoder(data)
    frames = []
    while (f := dec.decode_next()) is not None:
        frames.append(f)
    return frames


def _digests(frames, frame_size):
    import numpy as np
    return [hashlib.sha1(np.asarray(f)[:frame_size].tobytes()).hexdigest()
            for f in frames]


def batch_vs_host(data, window=16):
    """BatchVideoDecoder frames, byte-equal to the host decoder."""
    from mpeg_tpu.parallel import BatchVideoDecoder

    dec = BatchVideoDecoder(data, window=window)
    frames = []
    while got := dec.decode_window():
        frames += got
    size = dec.geom.frame_size
    got, want = _digests(frames, size), _digests(host_frames(data), size)
    _check(len(got) == len(want) > 0 and got == want,
           f"batch decode differs from the host decoder "
           f"({len(got)} vs {len(want)} frames)")
    return got


def picture_offsets(data):
    """Byte offsets of the picture start codes (00 00 01 00)."""
    offs, pos = [], data.find(b"\x00\x00\x01\x00")
    while pos >= 0:
        offs.append(pos)
        pos = data.find(b"\x00\x00\x01\x00", pos + 4)
    return offs


def staggered_streams(data, n):
    """n streams that end at different pictures: stream s drops the last
    6*s coded pictures, so the lockstep rounds see streams run dry (and
    flush) while the others still decode."""
    offs = picture_offsets(data)
    return [data if s == 0 else data[:offs[len(offs) - 6 * s]]
            for s in range(n)]


def multistream_vs_host(streams, window=2):
    """MultiStreamVideoDecoder, every stream byte-equal to the host."""
    from mpeg_tpu.parallel import MultiStreamVideoDecoder

    dec = MultiStreamVideoDecoder(streams, window=window)
    out = dec.decode_all()
    size = dec.geom.frame_size
    for s, (frames, data) in enumerate(zip(out, streams)):
        got, want = _digests(frames, size), _digests(host_frames(data),
                                                     size)
        _check(len(got) == len(want) > 0 and got == want,
               f"stream {s}: multistream differs from the host decoder "
               f"({len(got)} vs {len(want)} frames)")
    return f"{len(streams)} streams, {[len(o) for o in out]} frames"


def reconstruct_inputs(geom, seed=3):
    """One picture's reconstruct arguments at `geom`: random frames and
    coefficients, every block a full IDCT, random MC modes."""
    import numpy as np
    rng = np.random.default_rng(seed)
    mb = geom.mb_size
    frame = lambda: rng.integers(0, 256, geom.total_size).astype(np.uint8)
    return (frame(), frame(), frame(),
            rng.integers(-2000, 2000, (mb, 6, 64)).astype(np.int32),
            np.full((mb, 6), 64, np.int32),
            rng.integers(0, 2, (mb, 6)).astype(np.int32),
            rng.integers(0, 3, mb).astype(np.int32),
            rng.integers(-16, 17, mb).astype(np.int32),
            rng.integers(-16, 17, mb).astype(np.int32))


def reconstruct_floor_bytes(geom):
    """Bytes one reconstruct must move at least: read every input
    (cur, fwd, bwd, the int32 coefficients, the per-MB metadata) and
    write one frame."""
    args = reconstruct_inputs(geom)
    return sum(a.nbytes for a in args) + geom.total_size


def reconstruct_timing(geom, iters=200):
    """XLA reconstruct ms/picture over a warmed loop, and its floor."""
    import jax
    from mpeg_tpu.ops.video_recon import make_reconstruct_jax

    recon = make_reconstruct_jax(geom)
    args = [jax.device_put(a) for a in reconstruct_inputs(geom)]
    out = None
    for _ in range(3):
        out = recon(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = recon(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / iters * 1e3
    floor_b = reconstruct_floor_bytes(geom)
    floor_ms = floor_b / H100_HBM_BYTES_PER_S * 1e3
    return (f"{ms:.4f} ms/pic over {iters} pictures; floor "
            f"{floor_b / 1e6:.2f} MB = {floor_ms * 1e3:.2f} us at 3.35 TB/s "
            f"({ms / floor_ms:.1f}x the floor)")


def gpu_tests():
    """The `gpu`-marked tests, in this process, on this card."""
    import pytest
    os.environ["MPEG_TPU_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:xdist",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      os.path.join(REPO, "tests")])
    _check(rc == 0, f"gpu-marked tests: pytest exit code {int(rc)}")
    return "pytest -m gpu passed"


# -- four cards ---------------------------------------------------------------

def mesh_frame_digests(data, mesh, window):
    """Decode one copy of `data` per mesh device through
    make_sharded_blob_decoder; per-device lists of frame digests in
    display order (the reference's 1-frame delay and final flush)."""
    import numpy as np
    from mpeg_tpu import native
    from mpeg_tpu.parallel import sharding as sh
    from mpeg_tpu.parallel.batch import count_pool_records, pool_bucket
    from mpeg_tpu.tables import PICTURE_TYPE_B

    n = mesh.devices.size
    parser = native.NativeVideoParser(data)
    geom = parser.geom()
    plans = []
    while (item := parser.parse_next_plan()) is not None:
        plans.append(item)
    windows = [plans[i:i + window] for i in range(0, len(plans), window)]
    km = pool_bucket(max(count_pool_records(w)[0] for w in windows), 4096)
    ke = pool_bucket(max(max(count_pool_records(w)[1] for w in windows),
                         1), 64)
    decode = sh.make_sharded_blob_decoder(geom, mesh, window, km, ke)
    carry = sh.zero_carry(geom, n, mesh)
    frames = [[] for _ in range(n)]
    has_ref, last_type = False, 0
    for wplans in windows:
        blobs = sh.stack_stream_blobs([wplans] * n, geom, window, km, ke)
        carry, disps, _px = decode(carry, blobs)
        disps = np.asarray(disps)
        for i, (_plan, t) in enumerate(wplans):
            last_type = t
            if t == PICTURE_TYPE_B or has_ref:
                for s in range(n):
                    frames[s].append(disps[s, i])
            else:
                has_ref = True
    if has_ref and last_type != PICTURE_TYPE_B:
        bwd = np.asarray(carry[2])
        for s in range(n):
            frames[s].append(bwd[s])
    return [_digests(f, geom.frame_size) for f in frames], geom


def mesh_video(data, mesh, window, golden=None):
    """Mesh decode on every device equals the one-card decode (which
    equals the host decoder); with `golden`, that decode reproduces it,
    so every device does."""
    per_dev, geom = mesh_frame_digests(data, mesh, window)
    one_card = batch_vs_host(data, window=window)
    for s, got in enumerate(per_dev):
        _check(got == one_card, f"device {s}: mesh frames differ from "
               f"the one-card decode")
    if golden is not None:
        video_batch_golden(data, window)
    return (f"{mesh.devices.size} devices x {len(one_card)} frames of "
            f"{geom.width}x{geom.height} equal the one-card decode"
            + (f", golden {golden:#018x} on every device" if golden else ""))


def mesh_audio(mesh, window=32):
    """make_sharded_audio_synth over the whole MP2 fixture, one copy per
    device; each device's PCM must reproduce the audio golden."""
    import numpy as np
    from mpeg_tpu.ops.filterbank import finalize_np
    from mpeg_tpu.parallel import BatchAudioDecoder
    from mpeg_tpu.parallel import sharding as sh

    n = mesh.devices.size
    adec = BatchAudioDecoder(_read("test.mp2"), window=window)
    frames = []
    while (f := adec._parse_frame()) is not None:
        frames.append(f)
    synth = sh.make_sharded_audio_synth(mesh)
    hist = sh.zero_audio_hist(n, mesh)
    pcm = [[] for _ in range(n)]
    for i in range(0, len(frames), window):
        chunk = frames[i:i + window]
        samples = np.zeros((window, 36, 2, 32), np.int32)
        samples[:len(chunk)] = chunk
        stacked = np.broadcast_to(samples.reshape(-1, 2, 32),
                                  (n, window * 36, 2, 32)).copy()
        u, hist, _total = synth(stacked, hist)
        u = np.asarray(u).reshape(n, window, 36, 2, 32)[:, :len(chunk)]
        for s in range(n):
            pcm[s].append(finalize_np(u[s]).reshape(-1)
                          .astype("<f4").tobytes())
    for s in range(n):
        h = _fnv(pcm[s])
        _check(h == GOLDEN_AUDIO, f"device {s}: audio hash {h:#018x}")
    return f"{n} devices x {len(frames)} MP2 frames, golden on every device"


# -- driver -------------------------------------------------------------------

def run_phase(name, fn, *args, **kwargs):
    import jax
    c0, n0 = _COMPILE["seconds"], _COMPILE["count"]
    t0 = time.perf_counter()
    detail = fn(*args, **kwargs)
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    compile_s = _COMPILE["seconds"] - c0
    print(f"phase {name}: ok in {dt:.2f} s (compile {compile_s:.2f} s, "
          f"{_COMPILE['count'] - n0} compilations; peak_bytes_in_use "
          f"{stats.get('peak_bytes_in_use', 'n/a')}): {detail}",
          flush=True)
    return detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path")
    args = ap.parse_args(argv)

    from mpeg_tpu.utils.profiling import card_name_and_power_limit
    for line in card_name_and_power_limit():
        print(f"card: {line}", flush=True)

    import jax
    devices = jax.devices()
    dev = devices[0]
    print(f"jax {jax.__version__}: {len(devices)} x {dev.platform} "
          f"{dev.device_kind}", flush=True)
    if dev.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX platform {dev.platform!r})")
    from mpeg_tpu import native
    if not native.available():
        sys.exit("chip_smoke: the native parser did not build")
    from mpeg_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_on_duration)

    hd = _read("test1080.m1v")
    if args.four_cards:
        _check(len(devices) >= 4, f"--four-cards: {len(devices)} device(s)")
        from mpeg_tpu.parallel import sharding as sh
        mesh = sh.make_mesh(devices[:4])
        run_phase("mesh_fixture", mesh_video, _read("test.mpeg1video"),
                  mesh, 16, golden=GOLDEN_VIDEO)
        run_phase("mesh_1080p", mesh_video, hd, mesh, 8)
        run_phase("mesh_audio", mesh_audio, mesh)
        count = 4
    else:
        from mpeg_tpu.ops.video_recon import FrameGeometry
        run_phase("video_batch_golden", video_batch_golden)
        run_phase("video_interactive_golden", video_interactive_golden)
        run_phase("mpeg_av_parity", mpeg_av_parity)
        run_phase("audio_f32_golden", audio_f32_golden)
        run_phase("audio_s16_parity", audio_s16_parity)
        run_phase("1080p_batch", lambda: f"{len(batch_vs_host(hd))} "
                  "frames equal the host decoder")
        run_phase("1080p_multistream", multistream_vs_host,
                  staggered_streams(hd, 4))
        run_phase("reconstruct_1080p", reconstruct_timing,
                  FrameGeometry.for_size(1920, 1080))
        run_phase("gpu_tests", gpu_tests)
        count = len(devices)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
