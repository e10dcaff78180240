"""MP2 decoder tests: header metadata, golden end-to-end hash, backend parity.

Mirrors the reference test strategy (mpeg_test.go:135-201): the golden hash
anchors bit-exactness of the whole parse+synthesis pipeline.
"""

import struct

import numpy as np
import pytest

import mpeg_tpu as mpeg
from mpeg_tpu.utils import Fnv1a64

# Accepted golden hashes, one per FMA-contraction regime
# (mpeg_test.go:193-197).
GOLDEN_AUDIO_HASHES = {
    0xF1B76CDF8E6CDEA5,   # no FMA
    0x50F3AB75F5FB0FB5,   # windowing FMA
    0x245C591BB52C83B1,   # windowing + matrixing FMA
}


def new_audio(path, backend, parser="auto"):
    buf = mpeg.Buffer(open(path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    return mpeg.Audio(buf, backend=backend, parser=parser)


def test_audio_header(mp2_path):
    audio = new_audio(mp2_path, "numpy")
    assert audio.has_header()
    assert audio.samplerate() == 44100
    assert audio.get_channels() == 1

    audio.rewind()
    assert audio.decode() is not None


def decode_all_interleaved(audio):
    h = Fnv1a64()
    frames = 0
    while True:
        s = audio.decode()
        if s is None:
            break
        h.write(s.interleaved.astype("<f4").tobytes())
        frames += 1
    return h.sum64(), frames


@pytest.mark.parametrize("backend,parser", [
    ("numpy", "python"), ("numpy", "auto"), ("jax", "auto"),
])
def test_audio_golden(mp2_path, backend, parser):
    audio = new_audio(mp2_path, backend, parser)
    digest, frames = decode_all_interleaved(audio)
    assert frames > 0
    assert digest in GOLDEN_AUDIO_HASHES, \
        f"audio output hash {digest:#018x} (frames={frames})"


def test_audio_backend_parity(mp2_path):
    """numpy oracle and JAX path agree bitwise frame by frame."""
    a_np = new_audio(mp2_path, "numpy")
    a_jx = new_audio(mp2_path, "jax")
    for _ in range(8):
        s_np = a_np.decode()
        s_jx = a_jx.decode()
        assert (s_np is None) == (s_jx is None)
        if s_np is None:
            break
        if not np.array_equal(s_np.interleaved, s_jx.interleaved):
            diff = np.flatnonzero(s_np.interleaved != s_jx.interleaved)
            raise AssertionError(
                f"{diff.size} samples differ, first at {diff[0]}: "
                f"{s_np.interleaved[diff[0]]} vs {s_jx.interleaved[diff[0]]}")


def test_samples_formats(mp2_path):
    audio = new_audio(mp2_path, "numpy")
    s = audio.decode()
    assert s is not None
    assert len(s.bytes()) == len(s.interleaved) * 4
    assert s.left.shape == (mpeg.SAMPLES_PER_FRAME,)
    assert s.s16.dtype == np.int16

    s.format = mpeg.AudioFormat.S16
    assert len(s.bytes()) == len(s.interleaved) * 2


def test_samples_format_values(mp2_path):
    """S16/F32 scaling VALUES (not just lengths): asymmetric
    +-0x8000/0x7FFF (audio.go:387-418), truncation toward zero for S16,
    and the left/right de-interleave."""
    audio = new_audio(mp2_path, "numpy")
    # skip ahead so the frame has real signal, not leading silence
    for _ in range(10):
        s = audio.decode()
    assert s is not None
    inter = np.asarray(s.interleaved)
    assert np.count_nonzero(inter) > 100, "frame unexpectedly silent"
    assert inter.min() < 0 < inter.max(), "need both signs for the test"

    want_s16 = np.trunc(np.where(
        inter < 0, inter * np.float32(0x8000),
        inter * np.float32(0x7FFF))).astype(np.int16)
    np.testing.assert_array_equal(s.s16, want_s16)

    want_f32 = np.where(
        inter < 0, inter * np.float32(0x80000000),
        inter * np.float32(0x7FFFFFFF)).astype(np.float32)
    np.testing.assert_array_equal(s.f32, want_f32)

    np.testing.assert_array_equal(s.left, inter[0::2])
    np.testing.assert_array_equal(s.right, inter[1::2])

    s.format = mpeg.AudioFormat.S16
    assert s.bytes() == want_s16.tobytes()
    s.format = mpeg.AudioFormat.F32
    assert s.bytes() == want_f32.tobytes()


def test_streaming_audio_feed_matches_whole_buffer(mp2_path, mpg_path):
    """Audio streaming mode (feed() in chunks) reproduces the
    whole-buffer PCM exactly — ES golden hash and PS parity.  Partial
    windows must NOT synthesize mid-stream (the V-ring carry advances in
    whole windows)."""
    from mpeg_tpu.parallel import BatchAudioDecoder
    from mpeg_tpu.utils import Fnv1a64

    for path, is_ps in ((mp2_path, False), (mpg_path, True)):
        data = open(path, "rb").read()
        want = BatchAudioDecoder(data, window=32).decode_all()

        dec = BatchAudioDecoder(b"", window=32, streaming=True)
        chunks = []
        for i in range(0, len(data), 23456):
            dec.feed(data[i:i + 23456])
            while (pcm := dec.decode_window()) is not None:
                chunks.append(pcm)
        dec.signal_end()
        while (pcm := dec.decode_window()) is not None:
            chunks.append(pcm)
        got = np.concatenate(chunks)
        np.testing.assert_array_equal(got, want, err_msg=path.name)
        if not is_ps:
            h = Fnv1a64()
            h.write(got.astype("<f4").tobytes())
            assert h.sum64() in GOLDEN_AUDIO_HASHES


def test_div_out_scale_exact_bits():
    """The integer-mantissa division kernel reproduces the IEEE f32
    quotient u / OUT_SCALE bit-for-bit: random normals over the full
    exponent range plus directed boundary cases (the mantissa branch
    cut at M = 65*2^17, rounding carry into the exponent, signed zero,
    subnormal flush)."""
    import jax.numpy as jnp
    from mpeg_tpu.ops.filterbank import OUT_SCALE, div_out_scale_exact

    rng = np.random.default_rng(11)
    n = 200000
    bits = ((rng.integers(0, 1 << 23, n).astype(np.uint32)) |
            (rng.integers(1, 255, n).astype(np.uint32) << 23) |
            (rng.integers(0, 2, n).astype(np.uint32) << 31))

    # Directed mantissas around the shift-branch cut and the rounding
    # carry (q = 2^24 - 1 rounding up), across several exponents.
    directed = []
    for m in list(range((65 << 17) - 3, (65 << 17) + 4)) + \
            list(range((1 << 23), (1 << 23) + 8)) + \
            list(range((1 << 24) - 8, (1 << 24))):
        for e in (1, 100, 127, 200, 254):
            directed.append(((m & 0x7FFFFF) | (e << 23)))
    bits = np.concatenate([bits, np.asarray(directed, np.uint32),
                           np.asarray([0, 0x80000000], np.uint32)])
    u = bits.view(np.float32)

    want = u / np.float32(OUT_SCALE)          # numpy: correctly rounded
    got = div_out_scale_exact(u, np)
    got_j = np.asarray(div_out_scale_exact(jnp.asarray(u), jnp))

    want_bits = want.view(np.uint32)
    normal = (np.abs(want) >= np.float32(2 ** -126))
    for name, g in (("numpy", got), ("jax", got_j)):
        gb = g.view(np.uint32) if name == "numpy" else \
            np.asarray(g).view(np.uint32)
        np.testing.assert_array_equal(
            gb[normal], want_bits[normal],
            err_msg=f"{name}: normal quotients must match bit-for-bit")
        # subnormal quotients flush to signed zero
        sub = ~normal
        assert (gb[sub] & 0x7FFFFFFF).max(initial=0) == 0
        np.testing.assert_array_equal(
            gb[sub] >> 31, np.signbit(want[sub]).astype(np.uint32),
            err_msg=f"{name}: flushed zeros must keep the quotient sign")


def test_batch_audio_s16_device(mp2_path):
    """Device-quantized S16 output (out_format="s16") equals the host
    S16 lane exactly: trunc(s * 0x8000 / 0x7FFF) of the exact IEEE
    quotient (audio.go:401-407), int16 with wraparound."""
    from mpeg_tpu.parallel import BatchAudioDecoder

    data = open(mp2_path, "rb").read()
    f32 = BatchAudioDecoder(data, window=32).decode_all()
    want = np.trunc(np.where(
        f32 < 0, f32 * np.float32(0x8000),
        f32 * np.float32(0x7FFF))).astype(np.int16)

    got = BatchAudioDecoder(data, window=32, out_format="s16").decode_all()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def test_batch_audio_out_device(mp2_path):
    """out_device=True returns device-resident jax arrays (no d2h on
    the decode path) bit-identical to the host-returning paths for
    BOTH formats — the f32 normalization must go through the
    exact-IEEE constant-divisor kernel, never the backend's own f32
    divide (whose rounding is the compiler's choice)."""
    import jax
    from mpeg_tpu.parallel import BatchAudioDecoder

    data = open(mp2_path, "rb").read()
    for fmt in ("f32", "s16"):
        host = BatchAudioDecoder(data, window=32,
                                 out_format=fmt).decode_all()
        dev = BatchAudioDecoder(data, window=32, out_format=fmt,
                                out_device=True).decode_all()
        assert isinstance(dev, jax.Array)
        np.testing.assert_array_equal(np.asarray(dev), host,
                                      err_msg=fmt)


def test_batch_audio_prefetch_parity(mp2_path):
    """prefetch=True (producer-thread parse) returns the
    same PCM as inline parse, and close() poisons further decode."""
    import numpy as np
    from mpeg_tpu.parallel import BatchAudioDecoder

    data = open(mp2_path, "rb").read()
    want = BatchAudioDecoder(data, window=32).decode_all()
    got = BatchAudioDecoder(data, window=32, prefetch=True).decode_all()
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))

    dec = BatchAudioDecoder(data, window=32, prefetch=True)
    assert dec.decode_window() is not None
    dec.close()
    assert dec.decode_window() is None
    assert dec.decode_window() is None
