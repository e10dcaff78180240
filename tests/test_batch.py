"""Batched scan decoder parity: one-dispatch-per-window must reproduce the
sequential per-picture decode exactly (same 260 frames, same bytes)."""

import numpy as np
import pytest

import mpeg_tpu as mpeg
from mpeg_tpu.parallel import BatchVideoDecoder
from mpeg_tpu.utils import Fnv1a64

GOLDEN_VIDEO_HASH = 0xEA6D7FCB1340BA3F


def test_batch_scan_matches_golden(mpeg1video_path):
    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    dec = BatchVideoDecoder(buf, window=16)

    geom = None
    h = Fnv1a64()
    frames = 0
    while True:
        got = dec.decode_window()
        if not got:
            break
        geom = dec.geom
        for flat in got:
            flat = np.asarray(flat)
            h.write(flat[:geom.frame_size].tobytes())
            frames += 1

    assert frames == 260
    assert h.sum64() == GOLDEN_VIDEO_HASH, \
        f"batch hash {h.sum64():#018x} over {frames} frames"


def test_batch_decoder_rgba_output(mpeg1video_path):
    """BatchVideoDecoder(emit_rgba=True) returns fused on-device RGBA
    frames byte-identical to Frame.rgba(), including the end-of-stream
    flush frame."""
    data = open(mpeg1video_path, "rb").read()
    dec = BatchVideoDecoder(data, window=64, emit_rgba=True)
    frames = [np.asarray(f) for f in dec.decode_all()]
    assert len(frames) == 260
    assert frames[0].shape == (120, 160, 4)

    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    seq = mpeg.Video(buf, backend="numpy")
    for n in (0, 1, 128, 259):   # spot-check incl. the flushed last frame
        buf2 = mpeg.Buffer(open(mpeg1video_path, "rb"))
        buf2.set_load_callback(buf2.load_reader_callback)
        v = mpeg.Video(buf2, backend="numpy")
        for _ in range(n + 1):
            f = v.decode()
        np.testing.assert_array_equal(frames[n], f.rgba(),
                                      err_msg=f"frame {n}")


@pytest.mark.parametrize("fixture,use_native", [
    ("es", True), ("ps", True), ("es", False),
])
def test_streaming_feed_matches_whole_buffer(fixture, use_native,
                                             mpeg1video_path, mpg_path):
    """Streaming mode (feed() in chunks, decode between feeds) produces
    exactly the whole-buffer decode — native ES+PS and the Python-parse
    path (which must use a push-fed Buffer, not a reader-backed one:
    a drained reader reports has_ended mid-stream)."""
    path = mpeg1video_path if fixture == "es" else mpg_path
    data = open(path, "rb").read()

    whole = BatchVideoDecoder(data, window=8)
    want = [np.asarray(f).copy() for f in whole.decode_all()]

    dec = BatchVideoDecoder(b"", window=8, streaming=True,
                            use_native=use_native)
    got = []
    for i in range(0, len(data), 30011):
        dec.feed(data[i:i + 30011])
        got.extend(np.asarray(f).copy() for f in dec.decode_window())
    dec.signal_end()
    while chunk := dec.decode_window():
        got.extend(np.asarray(f).copy() for f in chunk)

    assert len(got) == len(want)
    for n, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), f"frame {n} differs"


def test_streaming_poll_before_any_bytes():
    """Polling a streaming decoder before any/enough bytes arrived must
    return empty results, not crash (video and audio)."""
    from mpeg_tpu.parallel import BatchAudioDecoder

    v = BatchVideoDecoder(b"", window=8, streaming=True, use_native=True)
    assert v.decode_window() == []
    v.feed(b"\x00\x00")   # container still unknown (< 4 bytes)
    assert v.decode_window() == []

    a = BatchAudioDecoder(b"", window=8, streaming=True)
    assert a.decode_window() is None
    assert a.samplerate == 0 and a.channels == 0
    a.feed(b"\x00\x00")
    assert a.decode_window() is None


@pytest.mark.parametrize("target", [0.0, 4.0, 8.6])
def test_clip_extraction_at_time(target, mpg_path):
    """Random-access clip decode (BatchVideoDecoder.at_time) starts at
    an intra frame at/before the target (GOPs are 3 s apart in the
    fixture) and its frames align exactly with a suffix of the full
    sequential decode."""
    data = open(mpg_path, "rb").read()
    got = BatchVideoDecoder.at_time(data, target, window=16)
    assert got is not None
    dec, pts = got
    frames = [np.asarray(f)[:dec.geom.frame_size]
              for f in dec.decode_all()]
    assert frames

    # Contract: chosen intra is at/before the target (anchored on
    # StartTime), within one GOP of it — or clamped to the first intra.
    m = mpeg.MPEG(open(mpg_path, "rb"), backend="numpy",
                  config=mpeg.Config(parser="python"))
    start = m.demux.get_start_time(mpeg.PACKET_VIDEO_1)
    assert pts <= start + target + 3.0 + 0.1
    if target >= 4.0:
        assert pts >= start + target - 3.1
        assert len(frames) < 230   # the prefix really was skipped

    # The clip must be an exact suffix of the whole-stream decode.
    full = BatchVideoDecoder(data, window=16)
    want = [np.asarray(f)[:full.geom.frame_size]
            for f in full.decode_all()]
    align = next((i for i in range(len(want))
                  if np.array_equal(want[i], frames[0])), None)
    assert align is not None, f"target {target}: clip start not found"
    for n, a in enumerate(frames):
        assert np.array_equal(a, want[align + n]), \
            f"target {target}: frame {n} (full[{align + n}]) differs"
    assert align + len(frames) == len(want)   # runs to stream end


def test_clip_extraction_small_window(mpg_path):
    """A tiny window whose first displays are all absorbed (reference
    delay + open-GOP B-drop) must not read as end-of-stream: the clip
    decodes the same frames as with a large window."""
    data = open(mpg_path, "rb").read()
    big, _ = BatchVideoDecoder.at_time(data, 4.0, window=16)
    want = [np.asarray(f).copy() for f in big.decode_all()]
    small, _ = BatchVideoDecoder.at_time(data, 4.0, window=2)
    got = [np.asarray(f).copy() for f in small.decode_all()]
    assert len(got) == len(want) and len(got) > 100
    for n, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a, b), f"frame {n} differs"


def test_blob_escape_lane():
    """Values with no exact int16 premultiplier quotient (junk-stream
    leaks, huge intra DCs) must round-trip through the escape lane: the
    blob transport has to reconstruct EXACTLY what the dense transport
    does for any int32 coefficients."""
    import jax.numpy as jnp
    from mpeg_tpu.ops.video_recon import FrameGeometry
    from mpeg_tpu.parallel.batch import (
        count_pool_records, make_blob_scan_decoder, make_dense_scan_decoder,
        pack_plans_blob, pool_bucket, stack_plans,
    )
    from mpeg_tpu.tables import (
        PICTURE_TYPE_B, PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE,
    )
    from mpeg_tpu.video import _PicturePlan

    geom = FrameGeometry.for_size(64, 48)
    mb = geom.mb_size
    rng = np.random.default_rng(3)
    window = 3
    plans = []
    for t, ptype in enumerate([PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE,
                               PICTURE_TYPE_B]):
        p = _PicturePlan(mb)
        p.coeffs[:] = rng.integers(-3000, 3000, (mb, 6, 64))
        p.coeffs[0, 0, 0] = 5            # not divisible by premult 32
        p.coeffs[0, 0, 63] = -7          # premult 2: trunc quotient inexact
        p.coeffs[1, 1, 0] = 1 << 22      # quotient exceeds int16
        p.nblocks[:] = rng.integers(0, 30, (mb, 6))
        if ptype == PICTURE_TYPE_INTRA:
            p.intra_blk[:] = 1
        else:
            p.src_sel[:] = rng.integers(0, 3, mb)
            p.mv_h[:] = rng.integers(-6, 7, mb)
            p.mv_v[:] = rng.integers(-6, 7, mb)
        plans.append((p, ptype))

    nm, ne = count_pool_records(plans)
    assert ne > 0, "escape lane not exercised"
    km, ke = pool_bucket(nm, 4096), pool_bucket(ne, 64)
    blob = pack_plans_blob(plans, geom, window, km, ke)

    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    _, disps_blob = make_blob_scan_decoder(geom, window, km, ke)(carry, blob)

    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    _, disps_dense = make_dense_scan_decoder(geom)(
        carry, stack_plans(plans, geom, window))

    np.testing.assert_array_equal(np.asarray(disps_blob),
                                  np.asarray(disps_dense))


def test_batch_scan_rgba(mpeg1video_path):
    """Fused device YCbCr->RGB output matches Frame.rgba() byte-for-byte."""
    import io
    from mpeg_tpu.parallel.batch import make_scan_decoder, stack_plans
    import jax.numpy as jnp

    buf = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    video = mpeg.Video(buf, backend="plan")
    assert video.has_header()
    geom = video.geom

    plans = []
    while len(plans) < 8:
        item = video.parse_next_plan()
        if item is None:
            break
        plans.append(item)

    scan = make_scan_decoder(geom, emit_rgba=True)
    z = jnp.zeros(geom.total_size, jnp.uint8)
    stacked = stack_plans(plans, geom, 8)
    _carry, disps = scan((z, z, z), stacked)
    disps = np.asarray(disps)
    assert disps.shape == (8, geom.height, geom.width, 4)

    # Map scan steps to sequential display order: step i displays iff the
    # picture is a B frame or a reference frame is already pending (the
    # 1-frame reference delay, video.go:247-256).
    from mpeg_tpu.tables import PICTURE_TYPE_B
    display_steps = []
    has_ref = False
    for i, (_, t) in enumerate(plans):
        if t == PICTURE_TYPE_B or has_ref:
            display_steps.append(i)
        else:
            has_ref = True

    # Reference: sequential decoder + host RGBA conversion, same pictures;
    # frame-indexed equality against the matching scan step.
    buf2 = mpeg.Buffer(open(mpeg1video_path, "rb"))
    buf2.set_load_callback(buf2.load_reader_callback)
    v2 = mpeg.Video(buf2, backend="numpy", parser="python")
    assert display_steps, "fixture prefix produced no displayed frames"
    for k, step in enumerate(display_steps):
        f = v2.decode()
        assert f is not None
        np.testing.assert_array_equal(
            disps[step], f.rgba(),
            err_msg=f"display {k} (scan step {step}) diverged")


def test_parse_thread_pool_parity(mpeg1video_path):
    """Two streams parsed by two CONCURRENT threads produce byte-identical
    window blobs to sequential parsing.  This is the BENCH_PARSE_THREADS
    scaling path: parsers share nothing and the ctypes window call
    releases the GIL, so on multi-core hosts host parse scales
    per-stream-per-core (this test proves correctness only; the scaling
    itself is unmeasured)."""
    from concurrent.futures import ThreadPoolExecutor

    from mpeg_tpu import native
    from mpeg_tpu.parallel.batch import blob_layout, blob_views, pool_bucket

    if not native.available():
        pytest.skip("needs the native parser")
    data = open(mpeg1video_path, "rb").read()
    window = 16

    probe = native.NativeVideoParser(data)
    geom = probe.geom()
    mb = geom.mb_size
    meta = (np.zeros(mb, np.int16), np.zeros(mb, np.int16),
            np.zeros(mb, np.uint16), np.zeros(mb, np.uint8))
    win_m = win_e = max_m = max_e = pics = 0
    while probe.blob_prepare() != 0:
        cm, ce = probe.blob_counts()
        win_m += cm
        win_e += ce
        hb = (mb * 6 * 64 >> 16) + 2   # single-picture hop bound
        probe.blob_emit(np.empty(2 * (cm + hb), np.uint16),
                        np.empty(ce + hb, np.uint16),
                        np.empty(ce + hb, np.int32), *meta, 0)
        pics += 1
        if pics % window == 0:
            max_m, max_e = max(max_m, win_m), max(max_e, win_e)
            win_m = win_e = 0
    max_m, max_e = max(max_m, win_m), max(max_e, win_e)
    slack = (window * mb * 6 * 64 >> 16) + window + 2   # hop records
    km = pool_bucket(max_m + slack, 4096)
    ke = pool_bucket(max(max_e + slack, 1), 64)
    _, total = blob_layout(geom, window, km, ke)

    def parse_stream(blob_2d, s, parser):
        """Fill stream s's rows of blob_2d [S, n_windows, total]."""
        for w in range(blob_2d.shape[1]):
            v = blob_views(blob_2d[s, w], geom, window, km, ke)
            types = np.empty(window, np.int32)
            n, nm, ne, pending, _pm, _pe = parser.blob_window(
                0, window, km, ke, 0, 0,
                v["main_rec"], v["esc_didx"], v["esc_val"],
                v["mv_h"], v["mv_v"], v["nbcls"], v["mbmisc"],
                v["flags"], types)
            assert pending == 0

    n_windows = -(-pics // window)
    # Sequential reference fill.
    seq = np.full((2, n_windows, total), 0x5A, np.uint8)
    for s in range(2):
        parse_stream(seq, s, native.NativeVideoParser(data))
    # Concurrent fill on a 2-thread pool into dirty buffers.
    par = np.full((2, n_windows, total), 0xC3, np.uint8)
    parsers = [native.NativeVideoParser(data) for _ in range(2)]
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda s: parse_stream(par, s, parsers[s]),
                      range(2)))
    np.testing.assert_array_equal(seq, par)


def test_batch_decoder_prefetch_parity(mpeg1video_path):
    """prefetch=True (background parse thread, depth-2 queue) must
    reproduce the serial decode exactly — same frames, same golden,
    including sticky pool-bucket growth mid-stream (the decoder starts
    at the minimum buckets, so the fixture's first I-heavy window grows
    them under the prefetch thread) and the end-of-stream flush."""
    data = open(mpeg1video_path, "rb").read()
    h = Fnv1a64()
    frames = 0
    dec = BatchVideoDecoder(data, window=16, prefetch=True)
    while got := dec.decode_window():
        for flat in got:
            h.write(np.asarray(flat)[:dec.geom.frame_size].tobytes())
            frames += 1
    assert frames == 260
    assert h.sum64() == GOLDEN_VIDEO_HASH

    # streaming + prefetch is an explicit error, not a silent fallback
    with pytest.raises(ValueError):
        BatchVideoDecoder(b"", window=16, streaming=True, prefetch=True)


def test_batch_decoder_blob_recycling_parity(mpeg1video_path):
    """Small windows force heavy window-blob recycling (the host buffer
    returns to the parse side with pool high-water marks once the
    window's output is ready — batch.py _reap_blobs); the golden must
    hold with and without the prefetch thread in the loop.  Guards two
    invariants: recycled tails beyond the high-water mark really are
    pad records, and a buffer is never handed back while the device
    can still read it (the CPU backend consumes device_put host
    buffers lazily, so output-readiness is the only safe gate)."""
    data = open(mpeg1video_path, "rb").read()
    for prefetch in (False, True):
        h = Fnv1a64()
        frames = 0
        dec = BatchVideoDecoder(data, window=3, prefetch=prefetch)
        while got := dec.decode_window():
            for flat in got:
                h.write(np.asarray(flat)[:dec.geom.frame_size].tobytes())
                frames += 1
        assert frames == 260, prefetch
        assert h.sum64() == GOLDEN_VIDEO_HASH, prefetch
        assert dec._blob_free or dec._blob_inflight   # recycling engaged


def test_batch_decoder_prefetch_close(mpeg1video_path):
    """close() stops a prefetch producer abandoned mid-stream (even
    with the queue full) and poisons further decode — the producer
    parsed ahead, so resuming would silently skip windows.  A decoder
    read to EOS shuts its own thread down and stays inline after."""
    import gc
    import threading

    data = open(mpeg1video_path, "rb").read()
    dec = BatchVideoDecoder(data, window=16, prefetch=True)
    assert dec.decode_window()          # producer running, queue filling
    before = threading.active_count()
    dec.close()
    assert dec._pf_thread is None
    assert threading.active_count() <= before
    assert dec.decode_window() == []    # poisoned, not frame-skipping

    # abandoning WITHOUT close(): the producer holds only a weakref, so
    # dropping the decoder lets GC reclaim it and the thread exit
    dec3 = BatchVideoDecoder(data, window=16, prefetch=True)
    assert dec3.decode_window()
    t3 = dec3._pf_thread
    del dec3
    gc.collect()
    t3.join(timeout=5)
    assert not t3.is_alive()

    # read-to-EOS path: same golden, thread self-terminates
    h = Fnv1a64()
    n = 0
    dec2 = BatchVideoDecoder(data, window=16, prefetch=True)
    while got := dec2.decode_window():
        for flat in got:
            h.write(np.asarray(flat)[:dec2.geom.frame_size].tobytes())
            n += 1
    assert n == 260 and h.sum64() == GOLDEN_VIDEO_HASH
    assert dec2._pf_thread is None      # EOS shut the producer down
    assert not dec2._prefetch           # post-EOS polling stays inline
    assert dec2.decode_window() == []


def test_batch_decoder_blob_recycling_ps_source(mpg_path):
    """Same recycling invariants on a PS source (pp_blob_window carries
    the high-water-mark ABI too): window=3 forces heavy recycling; the
    frames must equal a window=16 decode of the same program stream."""
    data = open(mpg_path, "rb").read()

    def frames_at(window):
        dec = BatchVideoDecoder(data, window=window)
        out = []
        while got := dec.decode_window():
            out += [np.asarray(f)[:dec.geom.frame_size].copy() for f in got]
        return out, dec

    base, _ = frames_at(16)
    small, dec3 = frames_at(3)
    assert len(base) == len(small) > 0
    for i, (a, b) in enumerate(zip(base, small)):
        assert (a == b).all(), f"frame {i}"
    assert dec3._blob_free or dec3._blob_inflight   # recycling engaged


def test_batch_decoder_4k_matches_host_decoder():
    """Geometry independence at UHD: the device scan path (mb_size =
    240 x 135 = 32,400 — 36x the 160x120 fixtures) must reproduce the
    C++ host-only decoder frame-for-frame.  Exercises the large-
    geometry branch of the recon VMEM gate (the fused Pallas stack
    exceeds its budget at 4K and must never be selected)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "..",
                        "bench_data", "test4k.m1v")
    if not os.path.exists(path):
        pytest.skip("4K bench fixture not present")
    data = open(path, "rb").read()

    from mpeg_tpu import native as native_mod
    dec = BatchVideoDecoder(data, window=4)
    assert (dec.geom.width, dec.geom.height) == (3840, 2160)
    frames = []
    while got := dec.decode_window():
        frames += [np.asarray(f)[:dec.geom.frame_size].copy() for f in got]

    host = native_mod.NativeHostDecoder(data)
    n = 0
    while (ref := host.decode_next()) is not None:
        assert (frames[n] == ref[:frames[n].size]).all(), f"frame {n}"
        n += 1
    assert n == 8 == len(frames)


def test_blob_inflight_overflow_drops_not_grows(mpeg1video_path):
    """A link stall must never grow the inflight deque unboundedly:
    past the cap, the oldest entry is dropped (its buffer is simply
    not recycled) and the free list stays bounded."""
    data = open(mpeg1video_path, "rb").read()
    dec = BatchVideoDecoder(data, window=16)

    class NeverReady:
        def is_ready(self):
            return False

    class AlwaysReady:
        def is_ready(self):
            return True

    for k in range(8):   # simulate 8 windows whose consumer never drains
        dec._blob_inflight.append(
            (NeverReady(), np.empty(1, np.uint8), (dec._km, dec._ke),
             (0, 0)))
        dec._reap_blobs()
    assert len(dec._blob_inflight) <= 5   # bounded under stall

    # recovery: ready gates drain into the (capped) free list
    for k in range(8):
        dec._blob_inflight.append(
            (AlwaysReady(), np.empty(1, np.uint8), (dec._km, dec._ke),
             (0, 0)))
    dec._reap_blobs()
    assert not dec._blob_inflight
    assert len(dec._blob_free) <= 3 + 1   # cap (+1 alloc-time pushback)
    dec.close()


def test_blob_recycling_survives_late_pool_growth(mpeg1video_path):
    """Force the pool-growth protocol to fire LATE, while recycled
    buffers (with their high-water marks) are already circulating:
    shrinking the sticky bucket mid-stream makes the next window hit
    the pending/grow path, which must drop stale-capacity buffers,
    re-pad conservatively (max of old capacity and buffer mark), and
    keep the golden."""
    data = open(mpeg1video_path, "rb").read()
    h = Fnv1a64()
    frames = 0
    dec = BatchVideoDecoder(data, window=4)
    windows = 0
    while got := dec.decode_window():
        for flat in got:
            h.write(np.asarray(flat)[:dec.geom.frame_size].tobytes())
            frames += 1
        windows += 1
        if windows == 10:
            dec._km = 4096   # force re-growth next window
    assert frames == 260
    assert h.sum64() == GOLDEN_VIDEO_HASH


def test_blob_hop_records_roundtrip():
    """Index gaps over 64K emit HOP records (delta 0xFFFF, value 0) so
    the uint16 delta chain can span them — no real fixture produces one
    (the 160x120 picture span is under 64K and 1080p/4K content is too
    dense), so this constructs sparse pictures whose within-picture and
    cross-picture gaps both exceed 64K and locks blob == dense."""
    import jax.numpy as jnp
    from mpeg_tpu.ops.video_recon import FrameGeometry
    from mpeg_tpu.parallel.batch import (
        blob_views, delta_encode, make_blob_scan_decoder,
        make_dense_scan_decoder, pack_plans_blob, pool_bucket, stack_plans,
    )
    from mpeg_tpu.tables import PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE
    from mpeg_tpu.video import _PicturePlan

    geom = FrameGeometry.for_size(640, 480)   # pic span 460,800 > 64K
    mb = geom.mb_size
    window = 2
    plans = []
    rng = np.random.default_rng(9)
    for t, ptype in enumerate([PICTURE_TYPE_INTRA,
                               PICTURE_TYPE_PREDICTIVE]):
        p = _PicturePlan(mb)
        # A record near the start and ones far apart: gaps of ~2-6
        # blocks' worth of 64K units within the picture, plus the
        # cross-picture jump from pic 0's early-ish last record to
        # pic 1's records.
        spots = [(0, 0, 0), (mb // 3, 2, 17), (mb - 1, 5, 63)]
        for m, b, pos in spots:
            p.coeffs[m, b, pos] = int(rng.integers(2, 60)) * 32
            p.nblocks[m, b] = pos + 1
            p.intra_blk[m, b] = 1 if ptype == PICTURE_TYPE_INTRA else 0
        p.src_sel[:] = 0
        plans.append((p, ptype))
    # drop pic 1's early record so the cross-picture gap is huge
    plans[1][0].coeffs[0, 0, 0] = 0
    plans[1][0].nblocks[0, 0] = 0

    (mi0, _, _, _) = __import__(
        "mpeg_tpu.parallel.batch", fromlist=["plan_pool_records"]
    ).plan_pool_records(plans[0][0])
    assert np.diff(mi0).max() > 0xFFFF   # the construction really gaps

    km, ke = pool_bucket(64, 4096), pool_bucket(1, 64)
    blob = pack_plans_blob(plans, geom, window, km, ke)
    v = blob_views(blob, geom, window, km, ke)
    rec = v["main_rec"].astype(np.int64)
    d, val = rec[0::2], rec[1::2]
    hops = ((d == 0xFFFF) & (val == 0) &
            (np.arange(km) < np.flatnonzero(val)[-1] + 1))
    assert hops.sum() >= 8, "construction must exercise hop records"

    import jax.numpy as jnp
    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    _, want = make_dense_scan_decoder(geom)(
        carry, stack_plans(plans, geom, window))
    carry = tuple(jnp.zeros(geom.total_size, jnp.uint8) for _ in range(3))
    _, got = make_blob_scan_decoder(geom, window, km, ke)(carry, blob)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_blob_malformed_chain_clamps():
    """A malformed blob whose delta chain runs past the window's dense
    span must not corrupt memory or scatter out of range: the densify
    clamps decoded indices to the last dense slot (monotonicity — and
    so the sorted-scatter promise — is preserved by the clamp)."""
    import jax
    import jax.numpy as jnp
    from mpeg_tpu.ops.video_recon import FrameGeometry
    from mpeg_tpu.parallel.batch import (
        blob_layout, blob_views, densify_blob_jax,
    )

    geom = FrameGeometry.for_size(64, 48)
    window, km, ke = 2, 4096, 64
    _, total = blob_layout(geom, window, km, ke)
    blob = np.zeros(total, np.uint8)
    v = blob_views(blob, geom, window, km, ke)
    rec = v["main_rec"]
    rec[0::2] = 0xFFFF                      # chain overshoots the span
    rec.view(np.int16)[1::2] = 3            # nonzero values throughout
    v["esc_didx"][:] = 0xFFFF
    v["esc_val"][:] = 7

    n = window * geom.mb_size * 6 * 64
    dense = np.asarray(jax.jit(
        lambda b: densify_blob_jax(b, geom, window, km, ke))(blob))
    assert dense.shape == (n,)
    # Everything past the span piles onto the clamped last slot; the
    # rest of the tensor holds only the in-range contributions.
    assert dense[-1] != 0
    assert np.isfinite(dense).all()
