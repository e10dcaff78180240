"""Stereo / joint-stereo / dual-channel MP2 coverage.

The repo's media fixtures are all mono 44.1 kHz, so the 2-channel
allocation loop, the joint-stereo bound (audio.py:355-369;
/root/reference/audio.go:228-230, 291-351) and true L != R interleaving
had no coverage.  No encoder exists in this
environment, so the streams are synthesized bit-exactly by
tools/gen_mp2.py (the mirror image of the frame parser) across a
mode x samplerate x bitrate matrix; golden hashes are locked from the
python-oracle decode, and every stream asserts python == native parser
and numpy == XLA filterbank parity.
"""

import os
import sys

import numpy as np
import pytest

import mpeg_tpu as mpeg
from mpeg_tpu.utils import Fnv1a64

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from gen_mp2 import gen_stream  # noqa: E402

# (name, mode, bitrate_index, samplerate_index, mode_ext, seed, sparsity,
#  frames, channels, samplerate, golden FNV-1a of interleaved f32 LE)
# Golden hashes locked from the python-oracle no-FMA decode (the same
# regime as the reference's TestAudioGolden no-FMA hash).
CONFIGS = [
    ("stereo_44k_192", 0x0, 9, 0, 0, 1, 0.10,
     24, 2, 44100, 0xA481F37E6DED1D42),
    ("stereo_48k_384", 0x0, 13, 1, 0, 2, 0.25,
     24, 2, 48000, 0xD076569E8DA28E78),
    ("joint0_44k_384", 0x1, 13, 0, 0, 3, 0.25,
     24, 2, 44100, 0x2DA4F4BBF2B1DFA6),
    ("joint3_32k_256", 0x1, 11, 2, 3, 4, 0.20,
     24, 2, 32000, 0x2174F349A04DA1D2),
    # Dual channel: decodes as 2 independent channels; the reference
    # quirk (audio.go:237-241) leaves Channels() untouched (0).
    ("dual_48k_256", 0x2, 11, 1, 0, 5, 0.15,
     24, 0, 48000, 0x395EEBA309F1C11E),
    ("mono_32k_192", 0x3, 9, 2, 0, 6, 0.25,
     24, 1, 32000, 0x53AA52D3327B0569),
]


def _stream(cfg) -> bytes:
    _, mode, bi, si, me, seed, sp, *_ = cfg
    return gen_stream(mode, bi, si, mode_ext=me, seed=seed, sparsity=sp)


def _decode_all(data: bytes, backend: str, parser: str):
    buf = mpeg.Buffer(None)
    buf.write(data)
    buf.signal_end()
    a = mpeg.Audio(buf, backend=backend, parser=parser)
    h = Fnv1a64()
    frames = 0
    l_ne_r = False
    while (s := a.decode()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
        if not np.array_equal(s.left, s.right):
            l_ne_r = True
        frames += 1
    return h.sum64(), frames, l_ne_r, a


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_mode_golden_python_oracle(cfg):
    name, mode, bi, si, me, seed, sp, frames, ch, sr, golden = cfg
    data = _stream(cfg)
    h, n, l_ne_r, a = _decode_all(data, "numpy", "python")
    assert n == frames
    assert a.get_channels() == ch
    assert a.samplerate() == sr
    # True 2-channel content must produce distinct L/R PCM.
    assert l_ne_r == (mode in (0x0, 0x1, 0x2))
    assert h == golden, hex(h)


@pytest.mark.parametrize("cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_mode_native_parser_parity(cfg):
    from mpeg_tpu import native
    if not native.available():
        pytest.skip("native parser unavailable")
    name, mode, bi, si, me, seed, sp, frames, ch, sr, golden = cfg
    data = _stream(cfg)
    h, n, _, a = _decode_all(data, "numpy", "native")
    assert n == frames
    assert a.get_channels() == ch
    assert h == golden, hex(h)


@pytest.mark.parametrize("cfg", CONFIGS[:4] + CONFIGS[5:],
                         ids=[c[0] for c in CONFIGS[:4] + CONFIGS[5:]])
def test_mode_device_filterbank_parity(cfg):
    """XLA filterbank lane (2-channel V-ring) matches the oracle
    bit-exactly in the no-FMA regime."""
    golden = cfg[-1]
    h, n, _, _ = _decode_all(_stream(cfg), "jax", "python")
    assert n == cfg[7]
    assert h == golden, hex(h)


def test_stereo_batch_decoder_parity():
    """BatchAudioDecoder (batched device filterbank) on true stereo
    content matches the per-frame oracle stream byte-for-byte."""
    from mpeg_tpu.parallel import BatchAudioDecoder
    cfg = CONFIGS[1]   # stereo_48k_384
    data = _stream(cfg)
    h = Fnv1a64()
    dec = BatchAudioDecoder(data, window=8, out_format="f32")
    while (pcm := dec.decode_window()) is not None:
        h.write(np.asarray(pcm).astype("<f4").tobytes())
    assert h.sum64() == cfg[-1], hex(h.sum64())


def test_joint_stereo_bound_values():
    """The four mode_extension values map to bounds 4/8/12/16
    (audio.go:244-245) and every one parses its first frame."""
    for me in range(4):
        data = gen_stream(0x1, 13, 0, mode_ext=me, seed=10 + me,
                          sparsity=0.2, frames=2)
        buf = mpeg.Buffer(None)
        buf.write(data)
        buf.signal_end()
        a = mpeg.Audio(buf, backend="numpy", parser="python")
        assert a.decode() is not None
        assert a.bound == (me + 1) << 2


def test_stereo_through_ps_pipeline(mpeg1video_path):
    """True stereo MP2 muxed into a program stream and decoded through
    the high-level MPEG class (fully-native PS pipeline): the audio PCM
    matches the ES-path golden for the same stream."""
    import io

    from ps_mux import mux  # tools/ on sys.path via the gen_mp2 import

    cfg = CONFIGS[1]   # stereo_48k_384, 24 frames = 0.576 s
    audio_es = _stream(cfg)
    video_es = open(mpeg1video_path, "rb").read()
    out = io.BytesIO()
    mux(video_es, audio_es, video_seconds=260 / 30.0,
        audio_seconds=24 * 1152 / 48000.0, target_seconds=2.0, out=out)

    m = mpeg.MPEG(out.getvalue(), backend="numpy")
    assert m.channels() == 2
    assert m.samplerate() == 48000
    h = Fnv1a64()
    n = 0
    # Hash exactly one loop of the 24-frame source: the mux loops it.
    while n < 24 and (s := m.decode_audio()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
        assert not np.array_equal(s.left, s.right) or s.interleaved.max() == 0
        n += 1
    assert n == 24
    assert h.sum64() == cfg[-1], hex(h.sum64())
