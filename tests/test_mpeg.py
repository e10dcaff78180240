"""High-level MPEG API tests, mirroring mpeg_test.go:276-461."""

import math

import pytest

import mpeg_tpu as mpeg


def new_mpeg(path, backend="numpy"):
    return mpeg.MPEG(open(path, "rb"), backend=backend)


def test_mpeg(mpg_path):
    m = new_mpeg(mpg_path)
    assert m.probe(5000 * 1024)
    assert m.has_headers()
    assert m.num_audio_streams() == 1
    assert m.num_video_streams() == 1
    assert m.width() == 160
    assert m.height() == 120
    assert m.framerate() == 30.0

    m.set_audio_stream(0)
    m.set_audio_enabled(True)
    assert m.audio_enabled
    m.set_video_enabled(True)
    assert m.video_enabled

    assert m.samplerate() == 44100
    assert m.channels() == 1

    m.set_audio_lead_time(1.0)
    assert m.audio_lead_time == 1.0

    assert int(m.duration()) == 9

    m.rewind()
    m.set_loop(False)
    assert not m.loop

    m.set_audio_enabled(False)
    m.set_video_enabled(True)
    frame = m.decode_video()
    assert frame is not None
    assert frame.width == m.width()
    assert frame.y.size == 20480
    assert frame.cb.size == frame.y.size // 4

    m.set_audio_enabled(True)
    m.set_video_enabled(False)
    samples = m.decode_audio()
    assert samples is not None
    assert len(samples.bytes()) == len(samples.interleaved) * 4

    m.set_audio_enabled(True)
    m.set_video_enabled(True)
    assert m.seek(1.0, False)

    frame = m.seek_frame(1.0, True)
    assert frame is not None

    # Seeking past the end clamps to the duration, returns the last frame.
    frame = m.seek_frame(100.0, True)
    assert frame is not None
    assert frame.time >= m.duration() - 1.0

    m.set_audio_callback(lambda mp, s: None)
    m.set_video_callback(lambda mp, f: None)
    m.decode(1.0)


def test_invalid_source():
    import io
    with pytest.raises(mpeg.InvalidMpegError):
        mpeg.MPEG(io.BytesIO(b"\x00" * 64))


def test_seek_audio_time(mpg_path):
    """Exact seek off a frame boundary keeps audio time in sync
    (mpeg_test.go:402-438)."""
    tolerance = 0.5
    times = []
    for ms in (1000, 2000, 3000, 3001, 4000, 5000):
        m = new_mpeg(mpg_path)
        m.set_audio_callback(lambda mp, s: None)
        m.set_video_callback(lambda mp, f: None)
        assert m.seek(ms / 1000.0, True), f"seek to {ms}ms failed"

        stream_time = m.get_time()
        audio_time = m.audio().get_time()
        assert abs(audio_time - stream_time) <= tolerance, \
            f"seek {ms}ms: audio {audio_time} vs stream {stream_time}"
        times.append(audio_time)

    # A 1ms change must not jump the audio time.
    assert abs(times[3] - times[2]) <= tolerance


@pytest.mark.parametrize("exact", [False, True])
def test_seek_video_callback_once(mpg_path, exact):
    m = new_mpeg(mpg_path)
    count = [0]
    m.set_video_callback(lambda mp, f: count.__setitem__(0, count[0] + 1))
    m.set_audio_callback(lambda mp, s: None)
    assert m.seek(3.0, exact)
    assert count[0] == 1


def test_loop_and_done(mpg_path):
    m = new_mpeg(mpg_path)
    m.set_video_enabled(True)
    m.set_audio_enabled(False)

    # Without looping, decoding past the end sets has_ended.
    n = 0
    while m.decode_video() is not None:
        n += 1
        assert n < 1000
    assert m.has_ended()
    assert m.done

    # With looping, the decoder rewinds instead of ending.
    m2 = new_mpeg(mpg_path)
    m2.set_video_enabled(True)
    m2.set_audio_enabled(False)
    m2.set_loop(True)
    first_n = n
    seen = 0
    while seen < first_n + 5:
        if m2.decode_video() is not None:
            seen += 1
        assert not m2.has_ended()
    assert seen > first_n   # wrapped around


def test_mpeg_jax_backend_smoke(mpg_path):
    """High-level API on the jax backend: a few frames of synced decode."""
    m = new_mpeg(mpg_path, backend="jax")
    assert m.has_headers()
    f = m.decode_video()
    assert f is not None and f.y.size == 20480
    s = m.decode_audio()
    assert s is not None and s.interleaved.size == 2304


@pytest.fixture(scope="session")
def es_1080_path(tmp_path_factory):
    """A short synthetic 1080p MPEG-1 ES (libavcodec PIM1 via cv2)."""
    cv2 = pytest.importorskip("cv2")
    import numpy as np
    path = tmp_path_factory.mktemp("es1080") / "t1080.m1v"
    avi = str(path) + ".avi"
    w, h = 1920, 1088
    vw = cv2.VideoWriter(avi, cv2.VideoWriter_fourcc(*"PIM1"), 30, (w, h))
    rng = np.random.default_rng(3)
    base = rng.integers(30, 220, (h // 128, w // 128, 3), np.uint8)
    base = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
    for i in range(5):
        m = np.float32([[1, 0, 3 * i], [0, 1, 2 * i]])
        vw.write(cv2.warpAffine(base, m, (w, h),
                                borderMode=cv2.BORDER_WRAP))
    vw.release()
    raw = open(avi, "rb").read()
    start = raw.find(b"\x00\x00\x01\xB3")
    end = raw.rfind(b"\x00\x00\x01\xB7")
    assert start >= 0
    es = raw[start:end + 4 if end > start else len(raw)]
    path.write_bytes(es)
    return path


def test_video_jax_backend_1080p_blob_transport(es_1080_path):
    """The interactive jax path at 1080p geometry: frames bit-match the
    numpy oracle, and the per-picture host->device payload is the
    pool-record blob (a small fraction of the dense coefficient
    tensor), so the reference-shaped API is also the fast path at large
    frames — parity with the reference, where DecodeVideo runs the same
    asm kernels as everything else (mpeg.go:416-433)."""
    import io

    import numpy as np

    from mpeg_tpu.buffer import Buffer
    from mpeg_tpu.video import Video

    data = open(es_1080_path, "rb").read()

    def frames(backend):
        buf = Buffer(io.BytesIO(data))
        buf.set_load_callback(buf.load_reader_callback)
        v = Video(buf, backend=backend, parser="python")
        out = []
        while (f := v.decode()) is not None:
            out.append(np.asarray(f.flat).copy())
        return out, v

    got, vj = frames("jax")
    want, _ = frames("numpy")
    assert vj.geom.width == 1920 and len(got) == len(want) >= 4
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a == b).all(), f"frame {i}"

    # Transport: the sticky per-picture blob is a small fraction of the
    # dense tensor the pre-blob interactive path shipped (mb*6*64 int32
    # = 12.0 MB at this geometry).
    from mpeg_tpu.parallel.batch import blob_layout
    _, blob_bytes = blob_layout(vj.geom, 1, vj._blob_km, vj._blob_ke)
    dense_bytes = vj.geom.mb_size * 6 * 64 * 4
    assert blob_bytes < dense_bytes / 10, (blob_bytes, dense_bytes)


class _NoSeekReader:
    """Non-seekable (single-pass) reader wrapper — exercises the
    TeeFeeder pipeline engine for pipe/socket-style sources."""

    def __init__(self, f):
        self._f = f

    def read(self, n=-1):
        return self._f.read(n)

    def seekable(self):
        return False


def _full_decode_digest(m):
    """Clock-driven full decode; returns (video hash, audio hash,
    frame count, sample count) over everything the callbacks saw."""
    from mpeg_tpu.utils import Fnv1a64
    vh, ah = Fnv1a64(), Fnv1a64()
    counts = [0, 0]

    def on_video(_m, f):
        vh.write(f.y.tobytes())
        vh.write(f.cb.tobytes())
        vh.write(f.cr.tobytes())
        counts[0] += 1

    def on_audio(_m, s):
        ah.write(s.interleaved.astype("<f4").tobytes())
        counts[1] += 1

    m.set_video_callback(on_video)
    m.set_audio_callback(on_audio)
    steps = 0
    while not m.done:
        m.decode(1.0 / 30.0)
        steps += 1
        assert steps < 5000, "decode loop did not terminate"
    return vh.sum64(), ah.sum64(), counts[0], counts[1]


def test_native_pipeline_hot_path(mpg_path, monkeypatch):
    """With the native pipeline, steady-state decode does ZERO Python
    packet routing (reference analog: the in-Go load-callback re-entry,
    mpeg.go:634-669), and the A/V output is bit-identical to the
    Python-routing engine."""
    from mpeg_tpu import native

    if not native.available():
        pytest.skip("native parser unavailable")

    m = new_mpeg(mpg_path)
    assert m._pipeline is not None, "expected the native pipeline engine"

    def boom(*_a, **_k):
        raise AssertionError("Python packet routing on the native hot path")

    monkeypatch.setattr(m, "_read_packets", boom)
    pipe_digest = _full_decode_digest(m)
    # No Python-side push buffers exist at all in pipeline mode.
    assert m.video_buffer is None and m.audio_buffer is None

    # Seek stays functional with routing still booby-trapped (the seek
    # protocol is native re-feed; only the byte-rate search is Python).
    m.rewind()
    assert m.seek(3.0, True)

    from mpeg_tpu.config import Config
    routed = mpeg.MPEG(open(mpg_path, "rb"), backend="numpy",
                       config=Config(parser="python"))
    assert routed._pipeline is None
    assert pipe_digest == _full_decode_digest(routed)


def test_native_pipeline_push_fed(mpg_path, monkeypatch):
    """A NON-seekable (pipe-style) source gets the same fully-native
    pipeline: zero per-packet Python on the steady state, output
    bit-identical to the seekable engine, with seek/rewind degraded
    exactly as the reference degrades non-seekable sources
    (buffer.go:74-76; mpeg.go:137,515: Probe/Seek are seekable-only);
    mpeg.py does not gate the pipeline on seekable()."""
    from mpeg_tpu import native

    if not native.available():
        pytest.skip("native parser unavailable")

    ref = _full_decode_digest(new_mpeg(mpg_path))

    m = mpeg.MPEG(_NoSeekReader(open(mpg_path, "rb")), backend="numpy")
    assert m._pipeline is not None, "expected the native pipeline engine"
    assert not m._seekable

    def boom(*_a, **_k):
        raise AssertionError("Python packet routing on the native hot path")

    monkeypatch.setattr(m, "_read_packets", boom)

    # Metadata flows through the teed control window + native pipeline.
    assert m.has_headers()
    assert m.width() == 160 and m.height() == 120
    assert m.samplerate() == 44100

    assert ref == _full_decode_digest(m)
    assert m.video_buffer is None and m.audio_buffer is None

    # Graceful degradation: no seek targets on a single-pass source.
    assert m.seek_frame(3.0, True) is None
    assert not m.seek(3.0, False)
    m.rewind()   # clock-only; must not blow up or re-read
    assert m.decode_video() is None   # stream is exhausted


def test_push_fed_control_cap(mpg_path, tmp_path):
    """A non-seekable stream larger than the TeeFeeder's control window
    still decodes fully at native speed: headers/start-time come from
    the teed prefix, and decode continues past the cap (the control
    Buffer simply stops growing — bounded memory)."""
    import io
    import os
    import sys

    from mpeg_tpu import native
    if not native.available():
        pytest.skip("native parser unavailable")

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    from ps_mux import mux

    video_es = open(os.path.join(os.path.dirname(__file__), "testdata",
                                 "test.mpeg1video"), "rb").read()
    audio_es = open(os.path.join(os.path.dirname(__file__), "testdata",
                                 "test.mp2"), "rb").read()
    out = io.BytesIO()
    mux(video_es, audio_es, video_seconds=260 / 30.0,
        audio_seconds=355 * 1152 / 44100.0, target_seconds=30.0, out=out)
    data = out.getvalue()

    cap = 1 << 20   # 1 MB control window << the ~10 MB stream
    from mpeg_tpu.config import Config
    m = mpeg.MPEG(_NoSeekReader(io.BytesIO(data)), backend="numpy")
    m._feeder.control_cap = cap
    frames = 0
    while m.decode_video() is not None:
        frames += 1
        if frames % 200 == 0:
            # Control window bounded at ~cap; native pipeline occupancy
            # stays bounded by compaction + the (unconsumed) audio
            # backlog of the stream decoded so far.
            assert len(m.demux.buf.bytes()) <= cap + (128 << 10)
    assert frames > 800           # decoded far past the control cap
    assert m._feeder.pos == len(data)
