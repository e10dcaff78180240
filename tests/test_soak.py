"""Long-form streaming soak: a minutes-class muxed PS exercising
bounded-memory streaming and A/V sync drift (SURVEY §5 long-context row;
the 9-second embedded fixture can't show either)."""

import os
import pathlib
import sys

import numpy as np
import pytest

import mpeg_tpu as mpeg

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))
from tools import ps_mux  # noqa: E402

# Ground truth of the embedded fixtures (SURVEY §4).
VIDEO_SECONDS = 261 / 30.0
AUDIO_SECONDS = 355 * 1152 / 44100.0
TARGET_SECONDS = 60.0


@pytest.fixture(scope="module")
def long_mpg(tmp_path_factory, mpeg1video_path, mp2_path):
    path = tmp_path_factory.mktemp("soak") / "long.mpg"
    with open(path, "wb") as f:
        ps_mux.mux(open(mpeg1video_path, "rb").read(),
                   open(mp2_path, "rb").read(),
                   VIDEO_SECONDS, AUDIO_SECONDS, TARGET_SECONDS, out=f)
    return path


def test_mux_parses_with_both_demuxers(long_mpg):
    """The muxed stream must demux identically on the Python oracle and
    the native demuxer, with monotone PTS per stream."""
    from mpeg_tpu import native

    buf = mpeg.Buffer(open(long_mpg, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    py = mpeg.Demux(buf)
    assert py.get_num_video_streams() == 1
    assert py.get_num_audio_streams() == 1

    nat = native.NativeDemuxer(open(long_mpg, "rb").read()) \
        if native.available() else None

    last_pts = {}
    packets = 0
    while (p := py.decode()) is not None:
        if nat is not None:
            a = nat.decode()
            assert a == (p.type, p.pts, bytes(p.data)), f"packet {packets}"
        if p.pts != mpeg.PACKET_INVALID_TS:
            assert p.pts >= last_pts.get(p.type, -1.0), "PTS not monotone"
            last_pts[p.type] = p.pts
        packets += 1
    assert packets > 1000
    assert last_pts[mpeg.PACKET_VIDEO_1] >= TARGET_SECONDS - 1.0


def test_seek_on_long_stream(long_mpg):
    """The byte-rate seek estimator over a minutes-class file: exact
    seeks land within the reference's 0.5 s contract (mpeg_test.go
    seek-coherence analog), far from the fixture's 9 s comfort zone."""
    m = mpeg.MPEG(open(long_mpg, "rb"))
    assert m.has_headers()
    dur = m.duration()
    assert dur >= TARGET_SECONDS - 1.0

    for target in (5.0, 23.7, 44.2, TARGET_SECONDS - 5.0):
        assert m.seek(target, True), f"seek({target}) failed"
        assert abs(m.time - target) < 0.5, \
            f"seek({target}) landed at {m.time:.3f}"
        # decode resumes normally from the seek point
        assert m.decode_video() is not None


def test_long_stream_native_pipeline_and_clip(long_mpg):
    """The fully-native PS pipeline and the clip extractor on a
    minutes-class stream: batch frame count matches the MPEG-class
    decode rate, and a deep clip decodes from the right neighborhood."""
    import numpy as np
    from mpeg_tpu import native
    from mpeg_tpu.parallel import BatchVideoDecoder

    if not native.available():
        pytest.skip("native parser unavailable")
    data = open(long_mpg, "rb").read()

    dec = BatchVideoDecoder(data, window=64)
    assert isinstance(dec.native, native.NativePipeline)
    total = sum(len(w) for w in iter(dec.decode_window, []))
    assert total >= (TARGET_SECONDS - 1.0) * 30

    clip = BatchVideoDecoder.at_time(data, 45.0, window=32)
    assert clip is not None
    cdec, pts = clip
    frames = cdec.decode_all()
    # intra within one GOP below the target; decodes to stream end
    assert 41.5 <= pts <= 46.5
    assert len(frames) >= (TARGET_SECONDS - 47.0) * 30
    assert np.asarray(frames[0])[:cdec.geom.frame_size].any()
    # O(window) scan contract: the byte-rate-seeded jump reads the scan
    # window around t=45 s, not the 45 s prefix.
    assert cdec._seek_scan_bytes < len(data) // 4, \
        (cdec._seek_scan_bytes, len(data))


def test_soak_bounded_memory_and_av_drift(long_mpg):
    """Clock-driven decode of the whole minute-long stream: stream
    buffers stay bounded (compaction works) and A/V clocks never drift
    apart by more than 0.5 s."""
    m = mpeg.MPEG(open(long_mpg, "rb"))
    assert m.has_headers()

    frames = [0]
    samples = [0]
    m.set_video_callback(lambda _m, f: frames.__setitem__(0, frames[0] + 1))
    m.set_audio_callback(
        lambda _m, s: samples.__setitem__(0, samples[0] + len(s.left)))

    max_occupancy = 0
    max_drift = 0.0
    tick = 1.0 / 30.0
    steps = 0
    while not m.done:
        m.decode(tick)
        steps += 1
        if steps % 16 == 0:
            # Demux window + both stream buffers (native-pipeline bytes
            # included when the MPEG class runs on the C++ pipeline).
            max_occupancy = max(max_occupancy, m.buffer_occupancy())
            vt = m.video_decoder.time
            at = m.audio_decoder.time
            max_drift = max(max_drift, abs(vt - at))
        assert steps < 20000, "decode loop did not terminate"

    duration = frames[0] / 30.0
    assert duration >= TARGET_SECONDS - 1.0, f"only {duration:.1f}s decoded"
    assert samples[0] / 44100.0 >= TARGET_SECONDS - 1.0
    # Bounded memory: a whole-file pull would be ~5 MB+; streaming
    # compaction keeps the working set under ~1.5 MB.
    assert max_occupancy < 1_500_000, f"buffers grew to {max_occupancy}"
    assert max_drift < 0.5, f"A/V drift reached {max_drift:.3f}s"
