"""MPEG-1 video frame reconstruction: IDCT + motion compensation + stores.

Device half of the video decoder.  The host parser (video.py) emits one
dense "picture plan" per coded picture:

- coeffs  int32 [mb, 6, 64]  premultiplied dequantized coefficients
  (exactly the reference's blockData before idct, video.go:716-744)
- nblocks int32 [mb, 6]      the coefficient count n per block (0 = block
  not coded; 1 = DC-only fast path; <10 = sparse IDCT; else full IDCT)
- intra   int32 [mb]         1 for intra-coded macroblocks
- src_sel int32 [mb]         0 = keep current content (untouched MB),
  1 = predict from forward frame, 2 = from backward frame (the reference's
  B-frame double-copy semantics collapse to "backward wins",
  video.go:626-633)
- mv_h/mv_v int32 [mb]       the motion vector actually used (full-pel
  doubling already applied)

The whole picture reconstructs in ONE dispatch with no scatter:

1. motion compensation is a 4-tap gather over the *flat* source frame
   buffer (planes share one padded allocation, so half-pel reads past a
   plane edge fall into the next plane's bytes exactly like the
   reference's shared-buffer overread, video.go:333-372);
2. the 8x8 IDCT is a vectorized integer butterfly over all 6*mb blocks,
   with the reference's three exact variants selected per block
   (video.go:772-798, 801-928);
3. residual application is pure reshape/transpose — luma blocks tile the
   plane as [mbH, 2, 8, mbW, 2, 8] — so XLA fuses everything into a
   gather + elementwise kernel.

All arithmetic is int32 (arithmetic shifts), bit-exact on every backend.
Runs under numpy (oracle) and jax.numpy (device) via the `xp` parameter.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class FrameGeometry:
    """Static per-sequence layout (parity: video.go:314-326, 333-372)."""

    width: int
    height: int
    mb_width: int
    mb_height: int

    @property
    def mb_size(self) -> int:
        return self.mb_width * self.mb_height

    @property
    def luma_width(self) -> int:
        return self.mb_width << 4

    @property
    def luma_height(self) -> int:
        return self.mb_height << 4

    @property
    def chroma_width(self) -> int:
        return self.mb_width << 3

    @property
    def chroma_height(self) -> int:
        return self.mb_height << 3

    @property
    def luma_size(self) -> int:
        return self.luma_width * self.luma_height

    @property
    def chroma_size(self) -> int:
        return self.chroma_width * self.chroma_height

    @property
    def frame_size(self) -> int:
        return self.luma_size + 2 * self.chroma_size

    @property
    def total_size(self) -> int:
        # Shared padded buffer: 16 extra luma rows for edge overreads
        # (video.go:338-340).
        return self.frame_size + self.luma_width * 16

    @classmethod
    def for_size(cls, width: int, height: int) -> "FrameGeometry":
        return cls(width, height, (width + 15) >> 4, (height + 15) >> 4)


def _plane_index_grids(h, mb_width, bw, shift, xp):
    """Per-(pixel row, mb column) slice index grids, built IN-GRAPH.

    Computing these from iota (rather than passing precomputed index
    arrays) lets XLA see the structure and pick its sliced-gather
    lowering instead of a per-pixel gather.
    """
    if xp is np:
        y, c = np.mgrid[0:h, 0:mb_width].astype(np.int32)
    else:
        y = xp.arange(h, dtype=xp.int32)[:, None] * \
            xp.ones((1, mb_width), xp.int32)
        c = xp.ones((h, 1), xp.int32) * \
            xp.arange(mb_width, dtype=xp.int32)[None, :]
    rowmb = (y >> shift) * mb_width + c
    return rowmb, y, c * bw


# --------------------------------------------------------------------------
# Integer 8x8 IDCT (parity: video.go:801-928)
# --------------------------------------------------------------------------

def _butterfly(b1, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift):
    """Shared 8-point core; x2 is the precomputed variant-specific term."""
    b7 = tmp1 + tmp2
    x4 = ((b6 * 473 - b4 * 196 + 128) >> 8) - b7
    x0 = x4 - (((tmp1 - tmp2) * 362 + 128) >> 8)
    x1 = m0 - b1
    x3 = m0 + b1
    y3 = x1 + x2
    y4 = x3 + b3
    y5 = x1 - x2
    y6 = x3 - b3
    y7 = -x0 - ((b4 * 473 + b6 * 196 + 128) >> 8)
    outs = (b7 + y4, x4 + y3, y5 - x0, y6 - y7,
            y6 + y7, x0 + y5, y3 - x4, y4 - b7)
    if final_shift:
        outs = tuple((o + 128) >> 8 for o in outs)
    return outs


def _pass_full(x, final_shift):
    """Full 8-point transform; x is a tuple of 8 arrays."""
    b1 = x[4]
    b3 = x[2] + x[6]
    b4 = x[5] - x[3]
    tmp1 = x[1] + x[7]
    tmp2 = x[3] + x[5]
    b6 = x[1] - x[7]
    m0 = x[0]
    x2 = (((x[2] - x[6]) * 362 + 128) >> 8) - b3
    return _butterfly(b1, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift)


def _pass_sparse(x, final_shift):
    """Sparse variant: inputs 4..7 assumed zero (video.go:807-866)."""
    b3 = x[2]
    b4 = -x[3]
    tmp1 = x[1]
    tmp2 = x[3]
    b6 = x[1]
    m0 = x[0]
    x2 = ((x[2] * 362 + 128) >> 8) - b3
    return _butterfly(0, b3, b4, tmp1, tmp2, b6, m0, x2, final_shift)


def _idct2d(blocks, xp, sparse):
    """2-D IDCT over [..., 8, 8] int32 blocks, one exact variant."""
    col_pass = _pass_sparse if sparse else _pass_full
    # Column transform: combine rows (inputs are row vectors [..., 8] or
    # [..., 4] for the sparse variant, which only touches columns 0..3 —
    # the sparse row pass never reads columns 4..7, so they are dropped).
    ncols = 4 if sparse else 8
    rows = tuple(blocks[..., r, :ncols] for r in range(8))
    cols_out = col_pass(rows, final_shift=False)   # 8 arrays [..., ncols]
    # Row transform: combine columns of the intermediate.
    cols = tuple(
        xp.stack([cols_out[r][..., c] for r in range(8)], axis=-1)
        for c in range(ncols)
    )   # ncols arrays of [..., 8]
    if sparse:
        row_out = _pass_sparse(cols, final_shift=True)
    else:
        row_out = _pass_full(cols, final_shift=True)
    return xp.stack(row_out, axis=-1)              # [..., 8, 8]


def idct_batch(coeffs, nblocks, xp):
    """Exact-variant IDCT over a batch of blocks.

    coeffs: int32 [..., 64]; nblocks: int32 [...]; returns int32 [..., 64]
    spatial values.  Variant per block: n==1 -> DC replicate
    (video.go:773-777), n<10 -> sparse, else full.
    """
    blocks = coeffs.reshape(coeffs.shape[:-1] + (8, 8))
    full = _idct2d(blocks, xp, sparse=False).reshape(coeffs.shape)
    sparse = _idct2d(blocks, xp, sparse=True).reshape(coeffs.shape)
    dc = xp.broadcast_to(((coeffs[..., 0:1] + 128) >> 8), coeffs.shape)

    n = nblocks[..., None]
    return xp.where(n == 1, dc, xp.where(n < 10, sparse, full))


# --------------------------------------------------------------------------
# Motion compensation + reconstruction
# --------------------------------------------------------------------------

def _trunc_div2(v):
    """Go-style integer division by 2, truncating toward zero."""
    return (v + ((v >> 31) & 1)) >> 1


_EXT_COLS = 32   # extension columns appended to each row for edge taps


def _gather_windows(src2d, ys, xs, bw, xp):
    """Gather [N, 2, bw+1] windows at 2-D (row, col) starts, clamped.

    This shape — iota-derived starts, (2, bw+1) slices — lets XLA lower
    it as a sliced gather rather than a per-pixel one.
    """
    if xp is np:
        rows, cols = src2d.shape
        ys = np.clip(ys, 0, rows - 2)
        xs = np.clip(xs, 0, cols - (bw + 1))
        return src2d[ys[:, None, None] + np.arange(2)[None, :, None],
                     xs[:, None, None] + np.arange(bw + 1)[None, None, :]]
    from jax import lax
    starts = xp.stack([ys, xs], axis=-1)
    return lax.gather(
        src2d, starts,
        lax.GatherDimensionNumbers(
            offset_dims=(1, 2), collapsed_slice_dims=(),
            start_index_map=(0, 1)),
        slice_sizes=(2, bw + 1),
        mode=lax.GatherScatterMode.CLIP)


def _mc_plane(src_flat, sel, hp, vp, oh, ov, sel_bwd,
              base, stride, bw, plane_h, geom, cur_plane, xp):
    """Motion-compensate one plane via one sliced window gather.

    The stacked [fwd | bwd] flat buffer is viewed as rows of `stride`
    bytes with 32 wrap-around extension columns (each row continues into
    the next row's first bytes), replicating the reference's FLAT buffer
    reads exactly — including right-edge half-pel taps that cross into
    the next row (video_noasm.go:49-50).

    Blend (parity: reference MC kernels, §2b of SURVEY):
      copy: a;  half-H: (a+b+1)>>1;  half-V: (a+c+1)>>1;
      bilinear: (a+b+c+d+2)>>2
    uniformly: (a + b*oh + c*ov + d*oh*ov + bias) >> (oh+ov).
    """
    rows2 = src_flat.shape[0] // stride
    src2d = src_flat.reshape(rows2, stride)
    ext = xp.concatenate(
        [src2d[1:, :_EXT_COLS],
         xp.zeros((1, _EXT_COLS), src2d.dtype)])
    src_ext = xp.concatenate([src2d, ext], axis=1)

    shift = 4 if bw == 16 else 3
    rowmb, y_px, x0 = _plane_index_grids(
        plane_h, geom.mb_width, bw, shift, xp)

    off = xp.where(sel_bwd, src_flat.shape[0] // 2, 0).astype(xp.int32)

    # Flat byte address of each slice start, then divmod back to (row, col):
    # exact flat-buffer semantics for every case, including junk-stream
    # reads that wrap into the previous row (xs stays in [0, stride), so
    # the +1 taps land in the extension columns).
    flat = (base + (y_px + vp[rowmb]) * stride + x0 + hp[rowmb] +
            off[rowmb]).reshape(-1)
    ys = flat // stride
    xs = flat % stride

    win = _gather_windows(src_ext, ys, xs, bw, xp).astype(xp.int32)
    a = win[:, 0, :bw]
    b = win[:, 0, 1:]
    c = win[:, 1, :bw]
    d = win[:, 1, 1:]

    oh_s = oh[rowmb].reshape(-1, 1)
    ov_s = ov[rowmb].reshape(-1, 1)
    sh = oh_s + ov_s
    bias = (1 << sh) >> 1
    pred = (a + b * oh_s + c * ov_s + d * (oh_s & ov_s) + bias) >> sh
    pred = pred.reshape(plane_h, geom.mb_width * bw)

    sel_px = xp.repeat(sel[rowmb], bw, axis=1)
    return xp.where(sel_px > 0, pred, cur_plane.astype(xp.int32))


def _luma_blocks_to_plane(vals, geom, xp):
    """[mb, 4, 64] block layout -> [lumaH, lumaW] plane (pure reshape)."""
    mh, mw = geom.mb_height, geom.mb_width
    v = vals.reshape(mh, mw, 2, 2, 8, 8)
    return xp.transpose(v, (0, 2, 4, 1, 3, 5)).reshape(
        geom.luma_height, geom.luma_width)


def _chroma_blocks_to_plane(vals, geom, xp):
    """[mb, 64] block layout -> [chromaH, chromaW] plane."""
    mh, mw = geom.mb_height, geom.mb_width
    v = vals.reshape(mh, mw, 8, 8)
    return xp.transpose(v, (0, 2, 1, 3)).reshape(
        geom.chroma_height, geom.chroma_width)


def reconstruct_picture(cur_flat, fwd_flat, bwd_flat,
                        coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v,
                        geom: FrameGeometry, xp):
    """Reconstruct one picture into a new flat frame buffer.

    cur/fwd/bwd_flat: uint8 [total_size] shared-layout frame buffers.
    Returns the new current buffer, uint8 [total_size].
    """
    # Select source frame per MB at gather time: gather from the stacked
    # [fwd | bwd] buffer with the MB's selection folded into the index.
    src_stack = xp.concatenate([fwd_flat, bwd_flat])

    # Per-MB motion terms.
    hp = mv_h >> 1
    vp = mv_v >> 1
    oh = mv_h & 1
    ov = mv_v & 1
    cm_h = _trunc_div2(mv_h)
    cm_v = _trunc_div2(mv_v)
    chp = cm_h >> 1
    cvp = cm_v >> 1
    coh = cm_h & 1
    cov = cm_v & 1
    sel_bwd = src_sel == 2

    # --- Luma ---
    cur_y = cur_flat[:geom.luma_size].reshape(
        geom.luma_height, geom.luma_width)
    pred_y = _mc_plane(
        src_stack, src_sel, hp, vp, oh, ov, sel_bwd,
        0, geom.luma_width, 16, geom.luma_height, geom, cur_y, xp)

    # --- Chroma (Cb, Cr) ---
    cb0 = geom.luma_size
    cr0 = geom.luma_size + geom.chroma_size
    cur_cb = cur_flat[cb0:cb0 + geom.chroma_size].reshape(
        geom.chroma_height, geom.chroma_width)
    cur_cr = cur_flat[cr0:cr0 + geom.chroma_size].reshape(
        geom.chroma_height, geom.chroma_width)

    pred_cb = _mc_plane(
        src_stack, src_sel, chp, cvp, coh, cov, sel_bwd,
        cb0, geom.chroma_width, 8, geom.chroma_height, geom, cur_cb, xp)
    pred_cr = _mc_plane(
        src_stack, src_sel, chp, cvp, coh, cov, sel_bwd,
        cr0, geom.chroma_width, 8, geom.chroma_height, geom, cur_cr, xp)

    # --- Residuals ---
    vals = idct_batch(coeffs, nblocks, xp)          # [mb, 6, 64]
    coded = (nblocks > 0).astype(xp.int32)          # [mb, 6]
    mb = coeffs.shape[0]

    def compose(pred, res, coded_px, intra_px):
        # coded blocks: clamp((intra ? 0 : pred) + residual); else keep pred
        base = xp.where(intra_px > 0, 0, pred)
        out = xp.where(coded_px > 0, xp.clip(base + res, 0, 255), pred)
        return out.astype(xp.uint8)

    def per_block_luma(a):        # [mb, 4] int32 -> per-pixel plane
        return _luma_blocks_to_plane(
            xp.broadcast_to(a[:, :, None], (mb, 4, 64)), geom, xp)

    def per_block_chroma(a):      # [mb] int32 -> per-pixel plane
        return _chroma_blocks_to_plane(
            xp.broadcast_to(a[:, None], (mb, 64)), geom, xp)

    out_y = compose(pred_y,
                    _luma_blocks_to_plane(vals[:, :4], geom, xp),
                    per_block_luma(coded[:, :4]),
                    per_block_luma(intra_blk[:, :4]))
    out_cb = compose(pred_cb,
                     _chroma_blocks_to_plane(vals[:, 4], geom, xp),
                     per_block_chroma(coded[:, 4]),
                     per_block_chroma(intra_blk[:, 4]))
    out_cr = compose(pred_cr,
                     _chroma_blocks_to_plane(vals[:, 5], geom, xp),
                     per_block_chroma(coded[:, 5]),
                     per_block_chroma(intra_blk[:, 5]))

    pad = cur_flat[geom.frame_size:]
    return xp.concatenate([
        out_y.reshape(-1), out_cb.reshape(-1), out_cr.reshape(-1), pad])


@functools.lru_cache(maxsize=None)
def make_reconstruct_jax(geom: FrameGeometry):
    """Jitted single-picture reconstruction for this geometry."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def recon(cur, fwd, bwd, coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v):
        return reconstruct_picture(
            cur, fwd, bwd, coeffs, nblocks, intra_blk, src_sel, mv_h, mv_v,
            geom, jnp)

    return recon
