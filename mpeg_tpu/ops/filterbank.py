"""MP2 synthesis filterbank: 32-band matrixing DCT + 512-tap D-window MAC.

This is the device half of the audio decoder.  The host parser emits the
dequantized subband samples as an int32 array of shape [36, 2, 32]
(36 sequential sub-block steps per MP2 frame x 2 channels x 32 subbands);
this module turns them into 1152 stereo PCM samples.

Numeric contract: bit-exact float32 against the reference's scalar Go code
(/root/reference/audio.go:377-424,492-772) in the no-FMA regime — every
multiply and add below is a separate f32 op in the same order as the
reference's statement sequence, vectorized over channels/streams (safe:
elementwise op order per sample is unchanged).

`dct32` is the reference's fully unrolled `idct36` butterfly
(audio.go:492-772) expressed once over an array namespace, so the numpy
oracle and the JAX device path share one transcription.
"""

from __future__ import annotations

import functools

import numpy as np

# The 32->64 matrixing butterfly constants, f32-rounded exactly as Go rounds
# its untyped float constants.
_C = [np.float32(c) for c in (
    0.500602998235, 0.505470959898, 0.515447309923, 0.53104259109,
    0.553103896034, 0.582934968206, 0.622504123036, 0.674808341455,
    0.744536271002, 0.839349645416, 0.972568237862, 1.16943993343,
    1.48416461631, 2.05778100995, 3.40760841847, 10.1900081235,
    0.502419286188, 0.52249861494, 0.566944034816, 0.64682178336,
    0.788154623451, 1.06067768599, 1.72244709824, 5.10114861869,
    0.509795579104, 0.601344886935, 0.899976223136, 2.56291544774,
    0.541196100146, 1.30656296488, 0.707106781187,
)]

# Output normalization divisor (audio.go:390).
OUT_SCALE = np.float32(-1090519040.0)


def dct32(x, xp, mul=None):
    """Matrixing DCT: subband samples -> one 64-float V-buffer block.

    x: int (..., 32) array; returns float32 (..., 64) laid out exactly as the
    reference writes d[dp+0..dp+63].  `xp` is numpy or jax.numpy.

    `mul` is the multiply hook (default plain `a * c`), kept so callers can
    instrument or guard the products.

    Bit-exactness caveat: the golden needs every mul and add rounded on
    its own (no FMA contraction).  XLA:GPU emits them as PTX `mul.rn.f32`
    / `add.rn.f32`; an explicit rounding modifier forbids ptxas from
    fusing them, and the H100 PTX of the synthesis holds no
    `fma.rn.f32`.  XLA:CPU's LLVM backend does contract mul+add chains
    into FMAs on FMA-capable hosts — run the CPU with
    XLA_FLAGS=--xla_cpu_max_isa=SSE4_2 (see utils/bitexact.py) when the
    golden contract matters there.
    """
    f32 = np.float32
    s = [x[..., i] for i in range(32)]

    if mul is None:
        def mul(a, c):
            return a * c

    def f(a):
        return xp.asarray(a).astype(f32)

    t01 = f(s[0] + s[31])
    t02 = mul(f(s[0] - s[31]), _C[0])
    t03 = f(s[1] + s[30])
    t04 = mul(f(s[1] - s[30]), _C[1])
    t05 = f(s[2] + s[29])
    t06 = mul(f(s[2] - s[29]), _C[2])
    t07 = f(s[3] + s[28])
    t08 = mul(f(s[3] - s[28]), _C[3])
    t09 = f(s[4] + s[27])
    t10 = mul(f(s[4] - s[27]), _C[4])
    t11 = f(s[5] + s[26])
    t12 = mul(f(s[5] - s[26]), _C[5])
    t13 = f(s[6] + s[25])
    t14 = mul(f(s[6] - s[25]), _C[6])
    t15 = f(s[7] + s[24])
    t16 = mul(f(s[7] - s[24]), _C[7])
    t17 = f(s[8] + s[23])
    t18 = mul(f(s[8] - s[23]), _C[8])
    t19 = f(s[9] + s[22])
    t20 = mul(f(s[9] - s[22]), _C[9])
    t21 = f(s[10] + s[21])
    t22 = mul(f(s[10] - s[21]), _C[10])
    t23 = f(s[11] + s[20])
    t24 = mul(f(s[11] - s[20]), _C[11])
    t25 = f(s[12] + s[19])
    t26 = mul(f(s[12] - s[19]), _C[12])
    t27 = f(s[13] + s[18])
    t28 = mul(f(s[13] - s[18]), _C[13])
    t29 = f(s[14] + s[17])
    t30 = mul(f(s[14] - s[17]), _C[14])
    t31 = f(s[15] + s[16])
    t32 = mul(f(s[15] - s[16]), _C[15])

    t33 = t01 + t31
    t31 = mul((t01 - t31), _C[16])
    t01 = t03 + t29
    t29 = mul((t03 - t29), _C[17])
    t03 = t05 + t27
    t27 = mul((t05 - t27), _C[18])
    t05 = t07 + t25
    t25 = mul((t07 - t25), _C[19])
    t07 = t09 + t23
    t23 = mul((t09 - t23), _C[20])
    t09 = t11 + t21
    t21 = mul((t11 - t21), _C[21])
    t11 = t13 + t19
    t19 = mul((t13 - t19), _C[22])
    t13 = t15 + t17
    t17 = mul((t15 - t17), _C[23])
    t15 = t33 + t13
    t13 = mul((t33 - t13), _C[24])
    t33 = t01 + t11
    t01 = mul((t01 - t11), _C[25])
    t11 = t03 + t09
    t09 = mul((t03 - t09), _C[26])
    t03 = t05 + t07
    t07 = mul((t05 - t07), _C[27])
    t05 = t15 + t03
    t15 = mul((t15 - t03), _C[28])
    t03 = t33 + t11
    t11 = mul((t33 - t11), _C[29])
    t33 = t05 + t03
    t05 = mul((t05 - t03), _C[30])
    t03 = t15 + t11
    t15 = mul((t15 - t11), _C[30])
    t03 = t03 + t15
    t11 = t13 + t07
    t13 = mul((t13 - t07), _C[28])
    t07 = t01 + t09
    t09 = mul((t01 - t09), _C[29])
    t01 = t11 + t07
    t07 = mul((t11 - t07), _C[30])
    t11 = t13 + t09
    t13 = mul((t13 - t09), _C[30])
    t11 = t11 + t13
    t01 = t01 + t11
    t11 = t11 + t07
    t07 = t07 + t13
    t09 = t31 + t17
    t31 = mul((t31 - t17), _C[24])
    t17 = t29 + t19
    t29 = mul((t29 - t19), _C[25])
    t19 = t27 + t21
    t21 = mul((t27 - t21), _C[26])
    t27 = t25 + t23
    t23 = mul((t25 - t23), _C[27])
    t25 = t09 + t27
    t09 = mul((t09 - t27), _C[28])
    t27 = t17 + t19
    t19 = mul((t17 - t19), _C[29])
    t17 = t25 + t27
    t27 = mul((t25 - t27), _C[30])
    t25 = t09 + t19
    t19 = mul((t09 - t19), _C[30])
    t25 = t25 + t19
    t09 = t31 + t23
    t31 = mul((t31 - t23), _C[28])
    t23 = t29 + t21
    t21 = mul((t29 - t21), _C[29])
    t29 = t09 + t23
    t23 = mul((t09 - t23), _C[30])
    t09 = t31 + t21
    t31 = mul((t31 - t21), _C[30])
    t09 = t09 + t31
    t29 = t29 + t09
    t09 = t09 + t23
    t23 = t23 + t31
    t17 = t17 + t29
    t29 = t29 + t25
    t25 = t25 + t09
    t09 = t09 + t27
    t27 = t27 + t23
    t23 = t23 + t19
    t19 = t19 + t31
    t21 = t02 + t32
    t02 = mul((t02 - t32), _C[16])
    t32 = t04 + t30
    t04 = mul((t04 - t30), _C[17])
    t30 = t06 + t28
    t28 = mul((t06 - t28), _C[18])
    t06 = t08 + t26
    t08 = mul((t08 - t26), _C[19])
    t26 = t10 + t24
    t10 = mul((t10 - t24), _C[20])
    t24 = t12 + t22
    t22 = mul((t12 - t22), _C[21])
    t12 = t14 + t20
    t20 = mul((t14 - t20), _C[22])
    t14 = t16 + t18
    t16 = mul((t16 - t18), _C[23])
    t18 = t21 + t14
    t14 = mul((t21 - t14), _C[24])
    t21 = t32 + t12
    t32 = mul((t32 - t12), _C[25])
    t12 = t30 + t24
    t24 = mul((t30 - t24), _C[26])
    t30 = t06 + t26
    t26 = mul((t06 - t26), _C[27])
    t06 = t18 + t30
    t18 = mul((t18 - t30), _C[28])
    t30 = t21 + t12
    t12 = mul((t21 - t12), _C[29])
    t21 = t06 + t30
    t30 = mul((t06 - t30), _C[30])
    t06 = t18 + t12
    t12 = mul((t18 - t12), _C[30])
    t06 = t06 + t12
    t18 = t14 + t26
    t26 = mul((t14 - t26), _C[28])
    t14 = t32 + t24
    t24 = mul((t32 - t24), _C[29])
    t32 = t18 + t14
    t14 = mul((t18 - t14), _C[30])
    t18 = t26 + t24
    t24 = mul((t26 - t24), _C[30])
    t18 = t18 + t24
    t32 = t32 + t18
    t18 = t18 + t14
    t26 = t14 + t24
    t14 = t02 + t16
    t02 = mul((t02 - t16), _C[24])
    t16 = t04 + t20
    t04 = mul((t04 - t20), _C[25])
    t20 = t28 + t22
    t22 = mul((t28 - t22), _C[26])
    t28 = t08 + t10
    t10 = mul((t08 - t10), _C[27])
    t08 = t14 + t28
    t14 = mul((t14 - t28), _C[28])
    t28 = t16 + t20
    t20 = mul((t16 - t20), _C[29])
    t16 = t08 + t28
    t28 = mul((t08 - t28), _C[30])
    t08 = t14 + t20
    t20 = mul((t14 - t20), _C[30])
    t08 = t08 + t20
    t14 = t02 + t10
    t02 = mul((t02 - t10), _C[28])
    t10 = t04 + t22
    t22 = mul((t04 - t22), _C[29])
    t04 = t14 + t10
    t10 = mul((t14 - t10), _C[30])
    t14 = t02 + t22
    t02 = mul((t02 - t22), _C[30])
    t14 = t14 + t02
    t04 = t04 + t14
    t14 = t14 + t10
    t10 = t10 + t02
    t16 = t16 + t04
    t04 = t04 + t08
    t08 = t08 + t14
    t14 = t14 + t28
    t28 = t28 + t10
    t10 = t10 + t20
    t20 = t20 + t02
    t21 = t21 + t16
    t16 = t16 + t32
    t32 = t32 + t04
    t04 = t04 + t06
    t06 = t06 + t08
    t08 = t08 + t18
    t18 = t18 + t14
    t14 = t14 + t30
    t30 = t30 + t28
    t28 = t28 + t26
    t26 = t26 + t10
    t10 = t10 + t12
    t12 = t12 + t20
    t20 = t20 + t24
    t24 = t24 + t02

    zero = xp.zeros_like(t01)
    # V-buffer block layout (audio.go:708-772): d[dp+j] for j = 0..63.
    out = [
        t05, t30, t27, t28, t07, t26, t23, t10,
        t15, t12, t19, t20, t13, t24, t31, t02,
        zero,
        -t02, -t31, -t24, -t13, -t20, -t19, -t12, -t15,
        -t10, -t23, -t26, -t07, -t28, -t27, -t30, -t05,
        -t14, -t09, -t18, -t11, -t08, -t25, -t06, -t03,
        -t04, -t29, -t32, -t01, -t16, -t17, -t21, -t33,
        -t21, -t17, -t16, -t01, -t32, -t29, -t04, -t03,
        -t06, -t25, -t08, -t11, -t18, -t09, -t14,
    ]
    return xp.stack(out, axis=-1)


def window_offsets(v_pos: int):
    """The 16 (d_index, v_index) block starts for one windowed MAC.

    Derived from the two-pass loop structure of the reference synthWindow
    (/root/reference/audio_noasm.go:8-38); the accumulation order of the 16
    32-float tap blocks is part of the numeric contract.
    """
    offs = []
    d_index = 512 - (v_pos >> 1)
    v_index = (v_pos % 128) >> 1
    while v_index < 1024:
        offs.append((d_index, v_index))
        v_index += 128
        d_index += 64
    d_index -= 512 - 32
    v_index = (128 - 32 + 1024) - v_index
    while v_index < 1024:
        offs.append((d_index, v_index))
        v_index += 128
        d_index += 64
    return offs


# --------------------------------------------------------------------------
# numpy oracle
# --------------------------------------------------------------------------

def synthesize_frame_np(samples: np.ndarray, v: np.ndarray, v_pos: int):
    """Scalar-oracle synthesis of one MP2 frame.

    samples: int32 [36, 2, 32]; v: float32 [2, 1024] ring state (mutated);
    returns (u float32 [36, 2, 32] — unnormalized window outputs, v, v_pos).
    """
    d = _d_window_np()
    out = np.empty((36, 2, 32), np.float32)
    for t in range(36):
        v_pos = (v_pos - 64) & 1023
        for ch in range(2):
            block = dct32(samples[t, ch].astype(np.int64), np)
            v[ch, v_pos:v_pos + 64] = block
            u = np.zeros(32, np.float32)
            for d_index, v_index in window_offsets(v_pos):
                u = u + d[d_index:d_index + 32] * v[ch, v_index:v_index + 32]
            out[t, ch] = u
    return out, v, v_pos


def finalize_np(u: np.ndarray) -> np.ndarray:
    """Normalize and interleave window outputs: [.., 36, 2, 32] -> [.., 2304].

    Runs on host, where numpy gives the exact IEEE quotient of
    audio.go:390 that the golden contract needs; a device f32 divide's
    rounding is its compiler's choice (device paths use
    div_out_scale_exact instead).
    """
    shape = u.shape[:-3] + (-1,)
    return np.swapaxes(u / OUT_SCALE, -1, -2).reshape(shape)


# OUT_SCALE = -1090519040 = -(65 << 24): division by it factors into an
# exact power-of-two exponent shift and a division of the 24-bit mantissa
# by 65.  That makes a correctly-rounded f32 divide expressible in pure
# int32 ops — which is how the device S16 path matches the host's exact
# IEEE quotient whatever the device's own f32 division rounds to.
assert int(-OUT_SCALE) == 65 << 24


def div_out_scale_exact(u, xp):
    """Bit-exact f32 `u / OUT_SCALE` via integer mantissa division.

    For normal results this reproduces the IEEE round-to-nearest-even
    quotient exactly (ties cannot occur: 65 is odd, so the true quotient
    is never halfway between representables).  Inputs whose quotient
    would be subnormal (|u| < 65 * 2^-103) flush to signed zero — callers
    quantizing to S16 never see the difference (|s| < 2^-15 truncates to
    0 either way).  `xp` is numpy or jax.numpy.
    """
    if xp is np:
        bits = u.view(np.int32)
    else:
        from jax import lax
        bits = lax.bitcast_convert_type(u, xp.int32)
    i32 = xp.int32
    su = (bits >> 31) & 1
    E = (bits >> 23) & 0xFF
    M = (bits & 0x7FFFFF) | 0x800000

    # M/65 in [2^16.98, 2^17.98): shift 6 when M/65 >= 2^17 else shift 7
    # puts the quotient in [2^23, 2^24) — a 24-bit mantissa.
    big = M >= (65 << 17)
    t = xp.where(big, M << 6, M << 7)
    q = t // 65
    r = t - q * 65
    mant = q + (r >= 33).astype(i32)   # round to nearest (no ties)
    E_out = E - xp.where(big, i32(30), i32(31))

    # (E_out << 23) + mant - 2^23 carries into the exponent when
    # rounding overflowed mant to 2^24 — exactly the renormalization.
    out_bits = (E_out << 23) + (mant - 0x800000)
    # c < 0 flips the sign; zero/subnormal input or subnormal result
    # flushes to signed zero.
    sign = (1 - su) << 31
    out_bits = xp.where((E == 0) | (E_out <= 0), 0, out_bits) | sign
    if xp is np:
        return out_bits.astype(np.int32).view(np.float32)
    from jax import lax
    return lax.bitcast_convert_type(out_bits.astype(xp.int32), xp.float32)


def s16_from_u(u, xp):
    """Window outputs -> interleaved S16, exactly the reference's
    AudioS16 lane (audio.go:401-407): s = u / -1090519040.0 (exact IEEE
    f32 quotient), then trunc(s * 0x8000) when s < 0 else
    trunc(s * 0x7FFF), narrowed to int16 with wraparound (the host
    Samples.s16 semantics).  u: (..., steps, 2, 32); returns the last
    three axes collapsed to (..., steps * 64) interleaved samples.

    Running this on device halves the d2h bytes vs the f32 path.
    """
    s = div_out_scale_exact(u, xp)
    scaled = xp.where(s < 0, s * np.float32(0x8000), s * np.float32(0x7FFF))
    # f32 -> int32 truncates toward zero on both numpy and XLA; the
    # int32 -> int16 narrowing wraps (matches np.trunc().astype(int16)).
    i = scaled.astype(xp.int32).astype(xp.int16)
    shape = i.shape[:-3] + (-1,)
    return xp.swapaxes(i, -1, -2).reshape(shape)


@functools.lru_cache(maxsize=None)
def make_finalize_jax():
    """Device-side finalize_np: normalization via the exact-IEEE
    constant-divisor kernel (div_out_scale_exact — the plain '/' is NOT
    used, its device rounding is not pinned) +
    interleave, for device-resident serving output
    ([.., 36, 2, 32] f32 -> [.., 2304])."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def finalize(u):
        s = div_out_scale_exact(u, jnp)
        shape = u.shape[:-3] + (-1,)
        return jnp.swapaxes(s, -1, -2).reshape(shape)

    return finalize


@functools.lru_cache(maxsize=None)
def make_synthesize_parallel_s16_jax():
    """The parallel synthesis fused with on-device S16 quantization:
    (samples [T,2,32] i32, hist) -> (s16 [T*64] int16, hist')."""
    import jax

    import jax.numpy as jnp

    synth = make_synthesize_parallel_jax()

    @jax.jit
    def synthesize(samples, hist):
        u, hist = synth(samples, hist)   # [T, 2, 32]
        return s16_from_u(u, jnp), hist  # [T * 64] interleaved

    return synthesize


_D_NP = None


def _d_window_np():
    global _D_NP
    if _D_NP is None:
        from ..tables import D_WINDOW
        _D_NP = D_WINDOW
    return _D_NP


# --------------------------------------------------------------------------
# JAX device path
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def make_synthesize_frame_jax():
    """Build the jitted per-frame synthesis: [36,2,32] i32 -> [36,2,32] f32.

    One dispatch per frame: a 36-step lax.scan carrying the V ring buffers.
    The windowed MAC unrolls the 16 tap blocks as explicit mul+add pairs to
    preserve the reference accumulation order (bit-exact on the H100, see
    dct32's caveat).  Output normalization happens host-side (see
    finalize_np).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    # numpy on purpose: an np constant embeds straight from host memory
    # at lowering time (a device-resident one would be fetched back).
    d_win = _d_window_np()

    def mac(u, dd, vv):
        return u + dd[None, :] * vv

    def step(carry, samples_t):
        v, v_pos = carry
        v_pos = (v_pos - 64) & 1023
        block = dct32(samples_t, jnp)                      # [2, 64]
        v = lax.dynamic_update_slice(v, block, (0, v_pos))
        u = jnp.zeros((2, 32), jnp.float32)

        d_index = 512 - (v_pos >> 1)
        v_index = (v_pos % 128) >> 1
        for _ in range(8):
            dd = lax.dynamic_slice(d_win, (d_index,), (32,))
            vv = lax.dynamic_slice(v, (0, v_index), (2, 32))
            u = mac(u, dd, vv)
            v_index = v_index + 128
            d_index = d_index + 64
        d_index = d_index - (512 - 32)
        v_index = (128 - 32 + 1024) - v_index
        for _ in range(8):
            dd = lax.dynamic_slice(d_win, (d_index,), (32,))
            vv = lax.dynamic_slice(v, (0, v_index), (2, 32))
            u = mac(u, dd, vv)
            v_index = v_index + 128
            d_index = d_index + 64
        return (v, v_pos), u

    @jax.jit
    def synthesize(samples, v, v_pos):
        (v, v_pos), out = lax.scan(step, (v, v_pos), samples)
        return out, v, v_pos

    return synthesize


def _residue_taps():
    """Tap tables for the parallel windowed MAC, per step-residue mod 16.

    At step t the V ring holds the DCT blocks of steps t-15..t; the
    two-pass window read (window_offsets) maps to 16 (d_slice,
    blocks-ago j, offset-in-block) taps.  Both the taps AND their
    accumulation ORDER depend on v_pos, which cycles with period 16 —
    so steps are grouped by t mod 16 (assuming a v_pos of 0 at window
    start), preserving the reference's float accumulation order exactly.
    """
    taps = []
    for m in range(16):
        v_pos = (-64 * (m + 1)) & 1023
        lst = []
        for d_idx, v_idx in window_offsets(v_pos):
            r = (v_idx - v_pos) % 1024
            j, off = divmod(r, 64)
            assert off in (0, 32) and 0 <= j < 16
            lst.append((d_idx, j, off))
        taps.append(lst)
    return taps


def hist_from_v(v: np.ndarray, v_pos: int) -> np.ndarray:
    """Extract the last-15-blocks history [15, 2, 64] from a V ring.

    hist[j-1] is the block written j steps ago (j = 1..15), i.e. at ring
    position (v_pos + 64*j) & 1023.
    """
    hist = np.zeros((15, 2, 64), v.dtype)
    for j in range(1, 16):
        p = (v_pos + 64 * j) & 1023
        hist[j - 1] = v[:, p:p + 64]
    return hist


def v_from_hist(blocks: np.ndarray, v_pos: int) -> np.ndarray:
    """Rebuild the V ring [2, 1024] from the last 16 blocks
    (blocks[0] = newest, at v_pos)."""
    v = np.zeros((blocks.shape[1], 1024), blocks.dtype)
    for j in range(16):
        p = (v_pos + 64 * j) & 1023
        v[:, p:p + 64] = blocks[j]
    return v


@functools.lru_cache(maxsize=None)
def make_synthesize_parallel_jax():
    """Fully parallel window synthesis: no per-step scan.

    samples: int32 [T, 2, 32] with T a multiple of 16 and the V write
    position 0 at window entry (true for windows of 4n whole frames:
    36 steps/frame, 4 frames = 144 steps = 9 ring periods);
    hist: float32 [15, 2, 64] — the previous 15 DCT blocks (newest
    first).  Returns (u [T, 2, 32], hist').

    All T matrixing DCTs compute at once; the windowed MAC becomes 16
    tap tables (one per step residue mod 16) of shifted strided block
    slices, accumulated in the reference's exact tap order — bit-exact
    vs the sequential scan.
    """
    import jax
    import jax.numpy as jnp

    # numpy on purpose (see make_synthesize_frame_jax).
    d_win = _d_window_np()
    taps = _residue_taps()

    @jax.jit
    def synthesize(samples, hist):
        t_len = samples.shape[0]
        assert t_len % 16 == 0, "window must cover 4n whole frames"
        n_grp = t_len // 16
        blocks = dct32(samples, jnp)                    # [T, 2, 64]
        # cat[15 + t] = block of step t; cat[15 + t - j] = t's j-ago block
        cat = jnp.concatenate([hist[::-1], blocks])     # [T+15, 2, 64]

        groups = []
        for m in range(16):
            u_m = jnp.zeros((n_grp, 2, 32), jnp.float32)
            for d_idx, j, off in taps[m]:
                start = 15 + m - j
                blk = cat[start:start + t_len:16, :, off:off + 32]
                u_m = u_m + d_win[d_idx:d_idx + 32][None, None, :] * blk
            groups.append(u_m)
        # interleave residue groups back into step order
        u = jnp.stack(groups, axis=1).reshape(t_len, 2, 32)
        new_hist = blocks[-1:-16:-1]                    # newest first
        return u, new_hist

    return synthesize
