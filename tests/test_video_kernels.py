"""Kernel parity tests vs scalar oracles (genre 2 of the reference's test
strategy: video_test.go:10-118)."""

import numpy as np
import pytest

from mpeg_tpu.ops import video_recon as vr
from tests.oracles import idct_scalar, copy_macroblock_scalar

RNG = np.random.default_rng(1234)


def random_block(n):
    """Block with nonzero coefficients only at scan positions < n."""
    from mpeg_tpu import tables as T
    block = np.zeros(64, np.int64)
    for scan in range(n):
        if scan == n - 1 or RNG.random() < 0.5:
            block[T.ZIG_ZAG[scan]] = int(RNG.integers(-2048 * 62, 2048 * 62))
    return block


@pytest.mark.parametrize("n", [2, 3, 5, 9, 10, 17, 33, 64])
def test_idct_parity(n):
    blocks = np.stack([random_block(n) for _ in range(16)])
    ns = np.full((16,), n, np.int32)
    got = vr.idct_batch(blocks.astype(np.int32), ns, np)
    for i in range(16):
        want = idct_scalar(blocks[i], n)
        assert np.array_equal(got[i], want), \
            f"idct n={n} block {i}: {got[i][:8]} vs {want[:8]}"


def test_idct_dc_only():
    blocks = np.zeros((4, 64), np.int32)
    blocks[:, 0] = [256, -256, 1000, 0]
    ns = np.ones(4, np.int32)
    got = vr.idct_batch(blocks, ns, np)
    for i in range(4):
        want = (blocks[i, 0] + 128) >> 8
        assert (got[i] == want).all()


def mc_sweep_geometry():
    return vr.FrameGeometry(width=64, height=64, mb_width=4, mb_height=4)


@pytest.mark.parametrize("sel", [1, 2])
def test_mc_parity_sweep(sel):
    """Mirror of the reference runParitySweep (video_test.go:71-103):
    mb positions x motion vectors in [-3, 3], bytewise-exact."""
    geom = mc_sweep_geometry()
    total = geom.total_size

    src = RNG.integers(0, 256, total, np.uint8).astype(np.uint8)
    src[geom.frame_size:] = 0   # pad stays zero, like initFrame
    other = RNG.integers(0, 256, total, np.uint8).astype(np.uint8)
    other[geom.frame_size:] = 0
    cur = RNG.integers(0, 256, total, np.uint8).astype(np.uint8)

    fwd, bwd = (src, other) if sel == 1 else (other, src)

    coeffs = np.zeros((geom.mb_size, 6, 64), np.int32)
    nblocks = np.zeros((geom.mb_size, 6), np.int32)
    intra = np.zeros((geom.mb_size, 6), np.int32)

    # Interior MBs only, like the reference sweep (video_test.go:71-103):
    # out-of-picture motion reads are out of contract (the reference
    # panics on them).
    for mb_row in (1, 2):
        for mb_col in (1, 2):
            mb = mb_row * geom.mb_width + mb_col
            for mh in range(-3, 4):
                for mv in range(-3, 4):
                    src_sel = np.zeros(geom.mb_size, np.int32)
                    mv_h = np.zeros(geom.mb_size, np.int32)
                    mv_v = np.zeros(geom.mb_size, np.int32)
                    src_sel[mb] = sel
                    mv_h[mb] = mh
                    mv_v[mb] = mv

                    got = vr.reconstruct_picture(
                        cur, fwd, bwd, coeffs, nblocks, intra,
                        src_sel, mv_h, mv_v, geom, np)

                    want = cur.copy()
                    copy_macroblock_scalar(
                        mh, mv, mb_row, mb_col,
                        geom.luma_width, geom.chroma_width,
                        src, want, geom.luma_size, geom.chroma_size)

                    if not np.array_equal(got, want):
                        d = np.flatnonzero(got != want)
                        raise AssertionError(
                            f"MC mismatch sel={sel} mb=({mb_row},{mb_col}) "
                            f"mv=({mh},{mv}): {d.size} bytes, first at "
                            f"{d[0]} got {got[d[0]]} want {want[d[0]]}")


def test_residual_add_and_intra():
    """Coded blocks: intra overwrite vs non-intra add-to-prediction."""
    geom = mc_sweep_geometry()
    cur = RNG.integers(0, 256, geom.total_size, np.uint8).astype(np.uint8)
    fwd = RNG.integers(0, 256, geom.total_size, np.uint8).astype(np.uint8)
    bwd = np.zeros(geom.total_size, np.uint8)

    coeffs = np.zeros((geom.mb_size, 6, 64), np.int32)
    nblocks = np.zeros((geom.mb_size, 6), np.int32)
    intra = np.zeros((geom.mb_size, 6), np.int32)
    src_sel = np.zeros(geom.mb_size, np.int32)
    mvz = np.zeros(geom.mb_size, np.int32)

    # MB 0: intra DC-only in all 6 blocks -> constant 100
    intra[0, :] = 1
    coeffs[0, :, 0] = 100 * 256
    nblocks[0, :] = 1

    # MB 1: predicted from fwd with +5 DC residual on luma block 0
    src_sel[1] = 1
    coeffs[1, 0, 0] = 5 * 256
    nblocks[1, 0] = 1

    got = vr.reconstruct_picture(
        cur, fwd, bwd, coeffs, nblocks, intra, src_sel, mvz, mvz,
        geom, np)

    y = got[:geom.luma_size].reshape(geom.luma_height, geom.luma_width)
    fy = fwd[:geom.luma_size].reshape(geom.luma_height, geom.luma_width)
    cy = cur[:geom.luma_size].reshape(geom.luma_height, geom.luma_width)

    assert (y[:16, :16] == 100).all()          # intra overwrite
    want = np.clip(fy[:8, 16:24].astype(int) + 5, 0, 255)
    assert (y[:8, 16:24] == want).all()        # block 0: +5 residual
    assert (y[:8, 24:32] == fy[:8, 24:32]).all()     # uncoded: prediction
    assert (y[8:16, 16:32] == fy[8:16, 16:32]).all()
    # untouched MB keeps current content
    assert (y[16:, 32:48] == cy[16:, 32:48]).all()


def random_plan(geom, rng, ptype):
    """Adversarial random plan: mixed MC modes, out-of-range junk MVs,
    sparse/full/DC IDCT classes, intra/predicted mixes."""
    from mpeg_tpu.video import _PicturePlan
    mb = geom.mb_size
    p = _PicturePlan(mb)
    p.coeffs[:] = rng.integers(-2047 * 32, 2047 * 32, (mb, 6, 64))
    p.nblocks[:] = rng.integers(0, 65, (mb, 6))
    if ptype == 1:
        p.intra_blk[:] = rng.integers(0, 2, (mb, 6))
    p.src_sel[:] = rng.integers(0, 3, mb)
    p.mv_h[:] = rng.integers(-40, 41, mb)
    p.mv_v[:] = rng.integers(-40, 41, mb)
    # a few junk-stream MVs far outside the frame (CLIP-mode parity)
    junk = rng.integers(0, mb, max(2, mb // 16))
    p.mv_h[junk] = rng.integers(-3000, 3000, junk.size)
    p.mv_v[junk] = rng.integers(-3000, 3000, junk.size)
    return p


def reconstruct_chain_parity(sizes, trials=3, seed=11):
    """The jitted device reconstruct must match the numpy oracle
    byte-for-byte over a chain of adversarial plans (junk MVs, the full
    copy / avgH / avgV / bilinear rounding family), each output feeding
    the next picture's references."""
    rng = np.random.default_rng(seed)
    for size in sizes:
        geom = vr.FrameGeometry.for_size(*size)
        recon = vr.make_reconstruct_jax(geom)
        cur, fwd, bwd = (rng.integers(0, 256, geom.total_size)
                         .astype(np.uint8) for _ in range(3))
        for trial in range(trials):
            p = random_plan(geom, rng, ptype=1 + (trial % 2))
            args = (cur, fwd, bwd, p.coeffs, p.nblocks, p.intra_blk,
                    p.src_sel, p.mv_h, p.mv_v)
            want = vr.reconstruct_picture(*args, geom, np)
            got = np.asarray(recon(*args))
            assert np.array_equal(got, want), \
                f"{size} trial {trial}: {np.flatnonzero(got != want)[:8]}"
            cur, fwd, bwd = got, bwd, cur


def test_reconstruct_adversarial_plans_match_oracle():
    # 80x48: one MB row group; 272x64: mb_width 17 (odd, not a power
    # of two).
    reconstruct_chain_parity([(80, 48), (272, 64)])
