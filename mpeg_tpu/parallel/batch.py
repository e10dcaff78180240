"""Batched video decode: a window of pictures in one device dispatch.

The per-picture data dependency in MPEG-1 is a strict depth-2 chain
(forward/backward reference frames, video.go:406-433).  That maps to a
`lax.scan` whose carry is the (current, forward, backward) frame triple and
whose per-step input is one parsed picture plan.  The scan compiles once
per (geometry, window) and reconstructs `window` pictures per dispatch —
amortizing dispatch latency and keeping the whole pipeline on-device.

Frame rotation and display selection replicate the reference exactly:

- reference picture (I/P): MC reads the old backward frame (the reference
  aliases forward=backward before the slices); afterwards
  backward=decoded, current=old forward; the DISPLAYED frame is the old
  backward (1-frame delay, video.go:247-256);
- B picture: MC reads both; displayed immediately.

Independent streams stack on a leading axis via `jax.vmap`; shard that
axis over a mesh with `shard_map` (see parallel/sharding.py).

Transport: the host->device bytes are the throughput bottleneck for large
frames (a dense 1080p coefficient tensor is 12.5 MB/picture, ~97% zeros).
The production transport is a single uint8 "window blob" per window:

- one coefficient POOL for the whole window sized by the window's ACTUAL
  record count (bucketed), not window * max-per-picture — I pictures are
  5-10x denser than P/B, so per-window pooling cuts the coefficient bytes
  ~4x on typical GOPs;
- pool records carry the UNPREMULTIPLIED quotient as int16 (the clipped
  level fits +-2048, video.go:737-742) and the device multiplies by the
  position's premultiplier (tables.PREMULTIPLIER_MATRIX); values that
  are not an exact premultiplier multiple (junk-stream scratch leaks,
  huge intra DCs) go to a small int32 ESCAPE lane — the encoding is
  decided per record by exact divisibility, so it is lossless by
  construction (an int8 quotient lane was tried and reverted: 29% of
  1080p records escape int8, erasing the win);
- record indices ship as uint16 DELTAS from the previous record's flat
  index (both pools are ascending end to end); a gap over 0xFFFF emits
  value-0 HOP records of delta 0xFFFF until the remainder fits, so the
  decode is one unconditional cumsum feeding the same sorted scatter —
  at 4 bytes per main record vs the 6 of (uint32 idx, int16 val), the
  h2d bytes of a 1080p picture drop ~1.5x;
- per-MB metadata packs to 7 bytes (mv 2x int16, a uint16 of 2-bit IDCT
  variant classes per block, and one uint8 of intra bits + src_sel) —
  the reconstruction only ever needs the variant class {0, 1, sparse,
  full} of nblocks, never the exact count (ops/video_recon.idct_batch).

The dense dict transport (stack_plans + make_dense_scan_decoder) remains
as the readable oracle used by tests.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..ops.video_recon import FrameGeometry, reconstruct_picture
from ..tables import (
    PICTURE_TYPE_B, PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE,
    PREMULTIPLIER_MATRIX,
)
from ..video import Frame, Video

_PREMULT = np.asarray(PREMULTIPLIER_MATRIX, np.int32)

# Representative nblocks value per 2-bit variant class; preserves every
# branch idct_batch takes (0 = uncoded, 1 = DC-only, <10 = sparse, full).
_NB_CLASS_REP = (0, 1, 2, 10)


def stack_plans(plans, geom: FrameGeometry, window: int):
    """Stack (plan, picture_type) pairs into dense scan inputs, padding
    with no-op steps (a no-op leaves the carry untouched)."""
    n = len(plans)
    assert n <= window
    mb = geom.mb_size
    out = {
        "coeffs": np.zeros((window, mb, 6, 64), np.int32),
        "nblocks": np.zeros((window, mb, 6), np.int32),
        "intra_blk": np.zeros((window, mb, 6), np.int32),
        "src_sel": np.zeros((window, mb), np.int32),
        "mv_h": np.zeros((window, mb), np.int32),
        "mv_v": np.zeros((window, mb), np.int32),
        "is_ref": np.zeros(window, np.int32),
        "is_noop": np.ones(window, np.int32),
    }
    for i, (plan, ptype) in enumerate(plans):
        out["coeffs"][i] = plan.coeffs
        out["nblocks"][i] = plan.nblocks
        out["intra_blk"][i] = plan.intra_blk
        out["src_sel"][i] = plan.src_sel
        out["mv_h"][i] = plan.mv_h
        out["mv_v"][i] = plan.mv_v
        out["is_ref"][i] = 1 if ptype in (PICTURE_TYPE_INTRA,
                                          PICTURE_TYPE_PREDICTIVE) else 0
        out["is_noop"][i] = 0
    return out


# --------------------------------------------------------------------------
# Window blob: one contiguous byte buffer per window
# --------------------------------------------------------------------------
#
# Per-array device_put costs one host->device round trip each; the blob
# packs every field of a window into ONE uint8 buffer (fixed little-endian
# layout), so a whole window is one transfer and the device unpacks with
# free bitcast/slice ops followed by a single scatter-add densify.

def _extract_sequence_header(es: bytes) -> bytes:
    """Slice the MPEG-1 sequence header (+ any extension/user data)
    from the head of a video elementary stream: from 00 00 01 B3 up to
    the first GOP/picture start code."""
    start = es.find(b"\x00\x00\x01\xB3")
    if start < 0:
        return b""
    pos = start + 4
    while True:
        nxt = es.find(b"\x00\x00\x01", pos)
        if nxt < 0:
            return b""   # header truncated
        if nxt + 3 < len(es) and es[nxt + 3] in (0x00, 0xB8):
            return es[start:nxt]
        pos = nxt + 3


def _pes_packet(stream_id: int, payload: bytes) -> bytes:
    """Minimal MPEG-1 PES packet (no PTS) around `payload`."""
    return (b"\x00\x00\x01" + bytes([stream_id]) +
            (len(payload) + 1).to_bytes(2, "big") + b"\x0F" + payload)


_MIN_KM = 4096    # minimum main-pool bucket (records)
_MIN_KE = 64      # minimum escape-pool bucket (records; escapes are
                  # junk-stream-only, near zero on spec streams)


def pool_bucket(n: int, floor: int) -> int:
    """Power-of-two capacity bucket covering n records."""
    k = max(floor, 1)   # floor 0 would never double
    while k < n:
        k *= 2
    return k


def blob_layout(geom: FrameGeometry, window: int, km: int, ke: int):
    """Field byte offsets within one window blob.

    flags     int32[window]      bit0 = is_ref, bit1 = valid step
    mv_h/mv_v int16[window*mb]   motion vector actually used
    nbcls     uint16[window*mb]  2-bit IDCT variant class per block
    mbmisc    uint8[window*mb]   bits0-5 per-block intra, bits6-7 src_sel
    esc_didx  uint16[ke]         escape records: delta chain (see below),
    esc_val   int32[ke]          full int32 coefficient value
    main_rec  uint16[2*km]       interleaved (didx, val) pairs: [2k] is
                                 the delta of flat index
                                 ((w*mb+m)*6+b)*64+pos from the previous
                                 record (chain starts at 0; 0xFFFF with
                                 value 0 may be a HOP covering part of a
                                 larger gap), [2k+1] the int16 quotient
                                 value / premultiplier[pos] (exact)

    The main lane sits LAST and its fill is a byte PREFIX: the dispatch
    transfers only meta+esc plus a power-of-two bucket of the filled
    records (the tail [fill, km) is all zeros by the pad/high-water-mark
    contract), so sparse windows ship a fraction of the sticky layout —
    pad slack was 72% of the bytes at window=2 on 1080p GOP content.

    Pads in all record lanes are zeros (a value-0 add at the chain's
    current index): constant, sorted-safe, recycled-buffer-friendly.
    """
    mb = geom.mb_size
    # The device decodes indices with an int32 cumsum.
    assert window * mb * 6 * 64 < 2 ** 31, "window dense span overflows int32"
    fields = [
        ("flags", 4 * window),
        ("mv_h", 2 * window * mb), ("mv_v", 2 * window * mb),
        ("nbcls", 2 * window * mb), ("mbmisc", window * mb),
        ("esc_didx", 2 * ke), ("esc_val", 4 * ke),
        ("main_rec", 4 * km),
    ]
    offs = {}
    pos = 0
    for name, size in fields:
        pos = (pos + 3) & ~3   # 4-byte align every field
        offs[name] = (pos, size)
        pos += size
    return offs, (pos + 3) & ~3


def blob_split(geom: FrameGeometry, window: int, km: int, ke: int) -> int:
    """Byte offset where the main record lane starts — everything before
    it (meta + escape lanes) is the fixed-size transfer unit; the main
    lane transfers as a bucketed prefix of its fill."""
    offs, _ = blob_layout(geom, window, km, ke)
    return offs["main_rec"][0]


def plan_pool_records(plan):
    """Split one plan's nonzero coefficients into (main, escape) records.

    main: (idx int64[], quot int16[]) where coeff == quot * premult[pos];
    escape: (idx int64[], val int32[]) for values with no exact int16
    quotient.  idx is the flat position within the picture (block*64+pos).
    """
    flat = plan.coeffs.reshape(-1)
    idx = np.flatnonzero(flat)
    v = flat[idx].astype(np.int64)
    p = _PREMULT[idx & 63].astype(np.int64)
    q = v // p
    main = (q * p == v) & (q >= -32768) & (q <= 32767)
    return (idx[main], q[main].astype(np.int16),
            idx[~main], v[~main].astype(np.int32))


_HOP = 0xFFFF


def delta_encode(idx: np.ndarray, prev: int = 0):
    """Delta-encode an ascending absolute index array into the blob's
    uint16 chain form: returns (didx uint16[n_out], pos int64[n]) where
    pos[k] is the output slot of input record k (the other slots are
    value-0 HOP records of delta 0xFFFF covering gaps over 64K)."""
    d = np.empty(idx.size, np.int64)
    if idx.size:
        d[0] = idx[0] - prev
        np.subtract(idx[1:], idx[:-1], out=d[1:])
    nh = np.maximum(d - 1, 0) // _HOP        # hop records before record k
    pos = np.arange(idx.size, dtype=np.int64) + np.cumsum(nh)
    didx = np.full(pos[-1] + 1 if idx.size else 0, _HOP, np.uint16)
    didx[pos] = (d - nh * _HOP).astype(np.uint16)
    return didx, pos


def _window_records(plans, mb: int, records=None):
    """Concatenate a window's (main, escape) records in window-absolute
    ascending index order: ((midx, mval), (eidx, eval))."""
    mi_l, mv_l, ei_l, ev_l = [], [], [], []
    for w, (plan, _ptype) in enumerate(plans):
        mi, mv, ei, ev = records[w] if records is not None \
            else plan_pool_records(plan)
        base = w * mb * 6 * 64
        mi_l.append(mi + base)
        mv_l.append(mv)
        ei_l.append(ei + base)
        ev_l.append(ev)
    cat = lambda parts, dt: (np.concatenate(parts) if parts
                             else np.zeros(0, dt))
    return ((cat(mi_l, np.int64), cat(mv_l, np.int16)),
            (cat(ei_l, np.int64), cat(ev_l, np.int32)))


def count_pool_records(plans) -> tuple[int, int]:
    """Exact (main, escape) encoded record counts — including hop
    records — for a window of plans packed by pack_plans_blob.  The
    macroblock count (which fixes the per-picture index bases and so
    the hop records) comes from the plans themselves."""
    if not plans:
        return 0, 0
    mb = plans[0][0].mv_h.shape[0]
    (mi, _), (ei, _) = _window_records(plans, mb)
    nm = delta_encode(mi)[0].size
    ne = delta_encode(ei)[0].size
    return nm, ne


def _nb_classes(nblocks) -> np.ndarray:
    """[mb, 6] coefficient counts -> packed uint16 of 2-bit classes."""
    n = nblocks
    cls = np.where(n <= 0, 0, np.where(n == 1, 1, np.where(n < 10, 2, 3)))
    return (cls << (2 * np.arange(6, dtype=np.int32))).sum(
        axis=1).astype(np.uint16)


def blob_views(blob: np.ndarray, geom: FrameGeometry, window: int,
               km: int, ke: int) -> dict:
    """Typed field views into one window blob (single source of truth
    for the Python-side layout; parser.cpp writes the same fields)."""
    offs, total = blob_layout(geom, window, km, ke)
    assert blob.size == total and blob.dtype == np.uint8
    mb = geom.mb_size

    def view(name, dtype, n):
        off, size = offs[name]
        assert np.dtype(dtype).itemsize * n <= size
        return blob[off:off + np.dtype(dtype).itemsize * n].view(dtype)

    return {
        "flags": view("flags", np.int32, window),
        "mv_h": view("mv_h", np.int16, window * mb),
        "mv_v": view("mv_v", np.int16, window * mb),
        "nbcls": view("nbcls", np.uint16, window * mb),
        "mbmisc": view("mbmisc", np.uint8, window * mb),
        "esc_didx": view("esc_didx", np.uint16, ke),
        "esc_val": view("esc_val", np.int32, ke),
        "main_rec": view("main_rec", np.uint16, 2 * km),
    }


def split_views(meta_esc: np.ndarray, main_buf: np.ndarray,
                geom: FrameGeometry, window: int, km: int, ke: int) -> dict:
    """blob_views over a SPLIT window blob: `meta_esc` holds the fixed
    prefix (metadata + escape lanes, blob_split bytes), `main_buf` the
    main record lane (4*km bytes).  Callers that transfer the two parts
    separately (bucketed main prefix) fill through these views; the
    native window call takes the same pointers either way."""
    offs, _ = blob_layout(geom, window, km, ke)
    split = offs["main_rec"][0]
    assert meta_esc.size == split and main_buf.size == 4 * km
    mb = geom.mb_size

    def view(name, dtype, n):
        off, size = offs[name]
        assert np.dtype(dtype).itemsize * n <= size
        return meta_esc[off:off + np.dtype(dtype).itemsize * n].view(dtype)

    return {
        "flags": view("flags", np.int32, window),
        "mv_h": view("mv_h", np.int16, window * mb),
        "mv_v": view("mv_v", np.int16, window * mb),
        "nbcls": view("nbcls", np.uint16, window * mb),
        "mbmisc": view("mbmisc", np.uint8, window * mb),
        "esc_didx": view("esc_didx", np.uint16, ke),
        "esc_val": view("esc_val", np.int32, ke),
        "main_rec": main_buf.view(np.uint16),
    }


def pack_plans_blob(plans, geom: FrameGeometry, window: int,
                    km: int, ke: int, records=None) -> np.ndarray:
    """Pack a window of (plan, picture_type) pairs into one uint8 blob.

    `records` optionally carries precomputed plan_pool_records results
    (one per plan) so callers that sized the buckets from the same
    records don't recompute them."""
    _, total = blob_layout(geom, window, km, ke)
    mb = geom.mb_size
    blob = np.zeros(total, np.uint8)
    v = blob_views(blob, geom, window, km, ke)
    flags = v["flags"]
    mvh = v["mv_h"].reshape(window, mb)
    mvv = v["mv_v"].reshape(window, mb)
    nbcls = v["nbcls"].reshape(window, mb)
    misc = v["mbmisc"].reshape(window, mb)

    (mi, mv), (ei, ev) = _window_records(plans, mb, records)
    mdidx, mpos = delta_encode(mi)
    edidx, epos = delta_encode(ei)
    if mdidx.size > km or edidx.size > ke:
        raise ValueError(
            f"pool capacity exceeded: main {mdidx.size}/{km}, "
            f"esc {edidx.size}/{ke}")
    rec = v["main_rec"]
    rec[0:2 * mdidx.size:2] = mdidx
    rec.view(np.int16)[1::2][mpos] = mv
    v["esc_didx"][:edidx.size] = edidx
    v["esc_val"][epos] = ev
    # Pad records in both lanes are zeros (np.zeros blob): a value-0 add
    # at the chain's final index — the cumsum-decoded pools stay
    # nondecreasing end to end (device scatter ABI: indices_are_sorted;
    # plan_pool_records emits ascending flat indices per picture and
    # window bases grow, so the real records are already sorted).
    for w, (plan, ptype) in enumerate(plans):
        mvh[w] = plan.mv_h.astype(np.int16)
        mvv[w] = plan.mv_v.astype(np.int16)
        nbcls[w] = _nb_classes(plan.nblocks)
        misc[w] = ((plan.intra_blk.astype(np.uint8)
                    << np.arange(6, dtype=np.uint8)).sum(axis=1)
                   | (plan.src_sel.astype(np.uint8) << 6))
        is_ref = ptype in (PICTURE_TYPE_INTRA, PICTURE_TYPE_PREDICTIVE)
        flags[w] = (1 if is_ref else 0) | 2
    return blob


def _blob_field(blob, offs, name, dtype, n):
    """Read one typed field out of a device blob (slice + bitcast;
    shared by the densify and metadata unpack stages — the layout
    contract lives in blob_layout alone)."""
    import jax.numpy as jnp
    from jax import lax

    off, _size = offs[name]
    width = jnp.dtype(dtype).itemsize
    raw = blob[off:off + n * width]
    if width == 1:
        return lax.bitcast_convert_type(raw, dtype)
    return lax.bitcast_convert_type(raw.reshape(n, width), dtype)


def densify_split_jax(meta_esc, main_rec_bytes, geom: FrameGeometry,
                      window: int, ke: int):
    """Stage-A device unpack: scatter-add the coefficient pools into the
    FLAT dense tensor int32[window*mb*6*64].

    `meta_esc` is the blob's fixed prefix (metadata + escape lanes);
    `main_rec_bytes` is a uint8 slice of the main record lane — any
    bucketed prefix of it (the tail beyond the fill is all zeros, and a
    zero record is a no-op add at the chain's current index), so sparse
    windows transfer and process a fraction of the sticky capacity.

    Main + escape lanes stay separate scatters summed at the end, and
    the result stays flat.  The blob scan decoder dispatches this as its
    own executable and feeds the result to the scatter-free scan stage
    (make_blob_scan_decoder).  That split was made for compile time on
    an earlier accelerator's toolchain; whether it still pays on the
    H100 is unmeasured.
    """
    import jax.numpy as jnp
    from jax import lax

    offs, _ = blob_layout(geom, window, 1, ke)   # esc offsets: km-free
    mb = geom.mb_size
    n = window * mb * 6 * 64
    # Indices ship as uint16 deltas (hop records bridge gaps over 64K
    # with value 0); one int32 cumsum rebuilds the absolute chain.  The
    # min(n-1) clamp is insurance against malformed blobs only — a
    # well-formed chain ends at/below the window's last real index —
    # and preserves monotonicity, so sortedness still holds.
    kt = main_rec_bytes.shape[0] // 4
    # One contiguous u32 load per record, lanes split with elementwise
    # mask/shift instead of a strided u16 column read of the pairs.
    rec = lax.bitcast_convert_type(
        main_rec_bytes.reshape(kt, 4), jnp.int32)
    midx = jnp.cumsum(rec & 0xFFFF)
    midx = jnp.minimum(midx, n - 1)
    mval = lax.shift_right_arithmetic(rec, 16)   # sign-extended int16
    contrib = mval * jnp.asarray(_PREMULT)[midx & 63]
    eidx = jnp.cumsum(_blob_field(
        meta_esc, offs, "esc_didx", jnp.uint16, ke).astype(jnp.int32))
    eidx = jnp.minimum(eidx, n - 1)
    eval_ = _blob_field(meta_esc, offs, "esc_val", jnp.int32, ke)
    # Blob ABI: each pool's decoded indices are nondecreasing (deltas
    # are unsigned; pads are value-0 records of delta 0), so both
    # scatters declare indices_are_sorted.  Two independent scatters
    # summed, not one .at[].add().at[].add() chain.
    main = jnp.zeros(n, jnp.int32).at[midx].add(
        contrib, indices_are_sorted=True)
    esc = jnp.zeros(n, jnp.int32).at[eidx].add(
        eval_, indices_are_sorted=True)
    return main + esc


def densify_blob_jax(blob, geom: FrameGeometry, window: int, km: int,
                     ke: int):
    """Whole-buffer form of densify_split_jax (sharded/oracle paths):
    slices the fixed prefix and the full main lane out of one blob."""
    split = blob_split(geom, window, km, ke)
    return densify_split_jax(blob[:split], blob[split:split + 4 * km],
                             geom, window, ke)


def unpack_blob_meta(blob, geom: FrameGeometry, window: int, km: int,
                     ke: int):
    """Stage-B device unpack: every scan input EXCEPT the dense
    coefficients (those come from densify_blob_jax, compiled apart —
    see its docstring).  Bitcast + shift arithmetic that XLA fuses."""
    import jax.numpy as jnp

    offs, _ = blob_layout(geom, window, km, ke)
    mb = geom.mb_size

    def get(name, dtype, n):
        return _blob_field(blob, offs, name, dtype, n)

    flags = get("flags", jnp.int32, window)
    mv_h = get("mv_h", jnp.int16, window * mb).astype(jnp.int32) \
        .reshape(window, mb)
    mv_v = get("mv_v", jnp.int16, window * mb).astype(jnp.int32) \
        .reshape(window, mb)
    nbcls = get("nbcls", jnp.uint16, window * mb).astype(jnp.int32) \
        .reshape(window, mb)
    cls = (nbcls[:, :, None] >> (2 * jnp.arange(6, dtype=jnp.int32))) & 3
    nblocks = jnp.asarray(_NB_CLASS_REP, jnp.int32)[cls]
    misc = get("mbmisc", jnp.uint8, window * mb).astype(jnp.int32) \
        .reshape(window, mb)
    intra_blk = (misc[:, :, None] >> jnp.arange(6, dtype=jnp.int32)) & 1
    src_sel = misc >> 6

    return {
        "nblocks": nblocks,
        "intra_blk": intra_blk,
        "src_sel": src_sel,
        "mv_h": mv_h,
        "mv_v": mv_v,
        "is_ref": flags & 1,
        "is_noop": 1 - ((flags >> 1) & 1),
    }


def unpack_blob_jax(blob, geom: FrameGeometry, window: int, km: int,
                    ke: int):
    """Unpack one window blob on device -> dense scan inputs dict
    (single-module form: densify + metadata together).

    This is the one-dispatch form, used by the sharded mesh decoder
    and tests.  Single-device decode splits it into two executables
    instead (make_blob_scan_decoder, see densify_split_jax)."""
    out = unpack_blob_meta(blob, geom, window, km, ke)
    out["coeffs"] = densify_blob_jax(blob, geom, window, km, ke) \
        .reshape(window, geom.mb_size, 6, 64)
    return out


# --------------------------------------------------------------------------
# Scan decoders
# --------------------------------------------------------------------------

def make_scan_step(geom: FrameGeometry, emit_rgba: bool = False):
    """The per-picture scan step over dense plan tensors (shared by the
    dense and blob decoders and the sharded mesh decoder)."""
    import jax.numpy as jnp

    def step(carry, plan):
        cur, fwd, bwd = carry
        is_ref, is_noop = plan["is_ref"], plan["is_noop"]
        run = 1 - is_noop

        # Reference pictures alias forward=backward before the slices.
        fwd_eff = jnp.where(is_ref > 0, bwd, fwd)
        new = reconstruct_picture(
            cur, fwd_eff, bwd, plan["coeffs"], plan["nblocks"],
            plan["intra_blk"], plan["src_sel"], plan["mv_h"], plan["mv_v"],
            geom, jnp)
        new = jnp.where(run > 0, new, cur)

        disp = jnp.where(is_ref > 0, bwd, new)
        if emit_rgba:
            # Fused on-device YCbCr->RGB (exact Go image/color integers).
            from ..ops.color import flat_frame_to_rgba
            disp = flat_frame_to_rgba(disp, geom, jnp)
        ref = (is_ref > 0) & (run > 0)
        cur2 = jnp.where(ref, fwd, new)
        fwd2 = jnp.where(ref, bwd, fwd)
        bwd2 = jnp.where(ref, new, bwd)
        return (cur2, fwd2, bwd2), disp

    return step


@functools.lru_cache(maxsize=None)
def make_dense_scan_decoder(geom: FrameGeometry, emit_rgba: bool = False):
    """Jitted scan over dense stacked plans (the oracle transport):
    (carry, stack_plans(...)) -> (carry, displays)."""
    import jax

    step = make_scan_step(geom, emit_rgba)

    @jax.jit
    def scan_decode(carry, plans):
        return jax.lax.scan(step, carry, plans)

    return scan_decode


@functools.lru_cache(maxsize=None)
def make_blob_scan_decoder(geom: FrameGeometry, window: int, km: int,
                           ke: int, emit_rgba: bool = False):
    """Scan over one window blob (the production transport):
    (carry, blob uint8[total_bytes]) -> (carry, displays).

    carry = (current, forward, backward) flat uint8 frame buffers;
    displays[t] = the frame the reference's Decode() would return after
    picture t.  Compiles once per (geometry, window, capacity buckets).
    The carry is donated — steady-state decode re-uses its buffers.

    Two executables per window, dispatched back-to-back with no host
    sync between them: the coefficient densify scatter compiles
    standalone (flat result, see densify_split_jax), then the
    scatter-free scan stage.
    """
    import jax

    step = make_scan_step(geom, emit_rgba)
    mb = geom.mb_size
    split = blob_split(geom, window, km, ke)

    @jax.jit
    def densify(meta_esc, main_part):
        return densify_split_jax(meta_esc, main_part, geom, window, ke)

    @functools.partial(jax.jit, donate_argnums=0)
    def scan_stage(carry, meta_esc, dense):
        xs = unpack_blob_meta(meta_esc, geom, window, km, ke)
        xs["coeffs"] = dense.reshape(window, mb, 6, 64)
        return jax.lax.scan(step, carry, xs)

    def scan_decode(carry, blob, fill=None):
        # Two transfers per window: the fixed meta+escape prefix, and a
        # power-of-two bucket of the FILLED main records ([fill, km) is
        # all zeros by the pad contract, and a zero record is a no-op,
        # so any bucket >= fill decodes identically).  Sparse windows
        # ship a fraction of the sticky layout; densify recompiles per
        # bucket actually seen (a handful, shape-keyed by jax.jit).
        nm = km if fill is None else fill[0]
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), km)
        meta_esc = jax.device_put(blob[:split])
        main_part = jax.device_put(blob[split:split + 4 * kt])
        return scan_stage(carry, meta_esc, densify(meta_esc, main_part))

    return scan_decode


# Backwards-compatible alias (pre-blob-v2 name).
make_scan_decoder = make_dense_scan_decoder


@functools.lru_cache(maxsize=None)
def make_picture_blob_recon(geom: FrameGeometry, km: int, ke: int):
    """Jitted SINGLE-picture reconstruction fed by a 1-picture window
    blob — the interactive decode path's transport (Video backend="jax",
    the MPEG class).  In the reference the one public API runs the same
    asm kernels as everything else (mpeg.go:416-433); here the
    interactive path rides the same pool-record transport as the batch
    decoder, so a 1080p picture ships ~0.1 MB instead of the 12.5 MB
    dense coefficient tensor.  Two executables like the window decoder
    (see densify_split_jax)."""
    import jax
    import jax.numpy as jnp

    mb = geom.mb_size
    split = blob_split(geom, 1, km, ke)

    @jax.jit
    def densify(meta_esc, main_part):
        return densify_split_jax(meta_esc, main_part, geom, 1, ke)

    @jax.jit
    def recon(cur, fwd, bwd, meta_esc, dense):
        meta = unpack_blob_meta(meta_esc, geom, 1, km, ke)
        return reconstruct_picture(
            cur, fwd, bwd, dense.reshape(mb, 6, 64),
            meta["nblocks"][0], meta["intra_blk"][0], meta["src_sel"][0],
            meta["mv_h"][0], meta["mv_v"][0], geom, jnp)

    def run(cur, fwd, bwd, blob, fill=None):
        # Prefix transfer like the window decoder: meta+esc plus a
        # bucket of the filled main records (P/B pictures ship a
        # fraction of the sticky layout).
        nm = km if fill is None else fill
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), km)
        meta_esc = jax.device_put(blob[:split])
        main_part = jax.device_put(blob[split:split + 4 * kt])
        return recon(cur, fwd, bwd, meta_esc, densify(meta_esc, main_part))

    return run


@functools.lru_cache(maxsize=None)
def _rgba_converter(geom: FrameGeometry):
    """Jitted flat-YCbCr -> RGBA (for the end-of-stream flush frame)."""
    import jax
    import jax.numpy as jnp
    from ..ops.color import flat_frame_to_rgba

    return jax.jit(lambda flat: flat_frame_to_rgba(flat, geom, jnp))


class BatchVideoDecoder:
    """Throughput-oriented video decoder: host parse feeding windowed
    device dispatches.

    Mirrors Video.decode()'s output sequence (including the 1-frame
    reference delay and end-of-stream flush) but reconstructs `window`
    pictures per device round trip.
    """

    def __init__(self, buf, window: int = None, transport: str = None,
                 use_native: bool = None, stats=None, config=None,
                 emit_rgba: bool = False, streaming: bool = False,
                 pool_buckets: tuple = None, prefetch: bool = False):
        """`buf` is a Buffer (Python parse) or bytes (native parse).

        use_native: parse with the C++ parser (requires blob transport);
        default: native when available and the input is bytes.
        stats: an optional utils.profiling.DecodeStats populated per
        window (parse/dispatch timing, bytes transferred).
        emit_rgba: displayed frames come back as [H, W, 4] uint8 RGBA
        (fused on-device BT.601, exact Go image/color integers) instead
        of flat YCbCr buffers.
        streaming: the input arrives incrementally via feed(); call
        signal_end() when the source is exhausted (decode_window returns
        whatever whole pictures are buffered in the meantime).  The
        Python-parse path streams via a push-fed Buffer instead.
        pool_buckets: optional (km, ke) initial pool capacities — size
        them from a discovery sweep to avoid mid-decode bucket growth
        (each growth recompiles the window scan).
        prefetch: parse/pack the next window on a background thread
        while the device consumes the current one — decode_window is
        then bound by max(parse, h2d+dispatch) instead of their sum
        (the native parser releases the GIL; the Python-parse path
        gains little).  Output order and values are identical.  Not
        available with streaming=True (feed() drives the parse there).
        Unset arguments fall back to `config` (default config.DEFAULT).
        """
        from ..config import DEFAULT
        cfg = config if config is not None else DEFAULT
        window = window if window is not None else cfg.window
        transport = transport if transport is not None else cfg.transport
        from .. import native as native_mod
        if use_native is None:
            use_native = isinstance(buf, (bytes, bytearray)) and \
                native_mod.available()
        self.native = None
        self.video = None
        self._native_mod = native_mod
        self._streaming = streaming
        self._ended = not streaming
        self._use_native = use_native
        self._prefix = b""   # bytes held back until the container is known
        if use_native:
            assert transport == "blob", "native parse emits blob records"
            data = buf if isinstance(buf, (bytes, bytearray)) else \
                bytes(buf.bytes())
            if data or not streaming:
                self._make_native(bytes(data))
        else:
            if isinstance(buf, (bytes, bytearray)):
                import io
                from ..buffer import Buffer
                if bytes(buf[:4]) == b"\x00\x00\x01\xBA":
                    raise ValueError(
                        "MPEG-PS input needs the native pipeline "
                        "(use_native=True) or the MPEG class; the Python "
                        "plan parser consumes elementary streams only")
                if streaming:
                    # Push-fed buffer: a reader-backed one would report
                    # has_ended as soon as the initial bytes drained.
                    b = Buffer(None)
                    if buf:
                        b.write(bytes(buf))
                else:
                    b = Buffer(io.BytesIO(bytes(buf)))
                    b.set_load_callback(b.load_reader_callback)
                buf = b
            self.video = Video(buf, backend="plan")
        if transport not in ("blob", "dense"):
            raise ValueError(f"unknown transport {transport!r} "
                             "(expected 'blob' or 'dense')")
        self.window = window
        self.transport = transport
        self.stats = stats
        self.emit_rgba = emit_rgba
        self._scan = None
        self._scan_caps = None
        self._carry = None
        self._has_reference_frame = False
        self._types: list[int] = []
        self._refs_parsed = 0
        self._drop_leading_b = False   # set by at_time (open-GOP cut)
        # Sticky pool capacity buckets (monotone growth limits recompiles:
        # the first I-heavy window sets the high-water mark).
        self._km = _MIN_KM
        self._ke = _MIN_KE
        if pool_buckets is not None:
            km, ke = pool_buckets
            self._km = pool_bucket(km, _MIN_KM)
            self._ke = pool_bucket(max(ke, 1), _MIN_KE)
        if prefetch and streaming:
            raise ValueError("prefetch=True requires streaming=False "
                             "(feed() drives the parse in streaming mode)")
        self._prefetch = prefetch
        self._pf_queue = None
        self._pf_thread = None
        self._closed = False
        self._cached_geom = None
        # Window-blob recycling: once a window's scan OUTPUT is ready
        # (proving the device fully read the blob — the CPU backend
        # aliases device_put host buffers and reads them lazily from
        # inside the jit, so readiness of the input array is NOT a safe
        # barrier), its host buffer returns through _blob_free carrying
        # the pool high-water marks of its last fill, so the native
        # tail pad is O(live records) instead of O(pool capacity) (see
        # NativeVideoParser.blob_window).  TWO producers append to
        # _blob_free — the dispatch thread (via _reap_blobs) and the
        # parse/prefetch thread (the zero-picture early return in
        # _native_window_blob hands its untouched buffer straight
        # back) — and only the parse thread pops.  CPython deque
        # append/popleft are GIL-atomic, so this needs no lock; the
        # free-list cap in _reap_blobs is best-effort (the dual
        # producer can exceed it by one).
        import collections
        self._blob_inflight = collections.deque()
        self._blob_free = collections.deque()

    @classmethod
    def at_time(cls, data: bytes, seek_time: float, **kwargs):
        """Random-access clip decode: a fresh decoder positioned at the
        intra frame at/before `seek_time` of an MPEG-PS byte buffer
        (serving-style clip extraction without decoding the prefix).

        Returns (decoder, packet_pts) or None when no intra packet is
        found.  The scan is seeded by the demuxer's byte-rate estimate
        (demux.py get_duration / seek's own anchor), so deep targets
        read O(scan window) bytes, not O(stream): jump a margin before
        the target, scan deterministically forward, and widen the
        margin backwards only when the jump overshot every intra at or
        before the target; the stream-head linear scan remains as the
        final fallback (and the clamp-to-first-intra path for too-early
        targets).  The clip is the PS pack+system headers plus the
        stream from the intra packet on — the same tune-in contract as
        the reference's intra seek (streams carry per-GOP sequence
        headers).  The decoder's `_seek_scan_bytes` records the bytes
        examined (asserted O(window) by the soak test).
        """
        import io
        from ..buffer import Buffer
        from ..demux import (
            Demux, PACKET_INVALID_TS, PACKET_VIDEO_1, REORDER_WINDOW,
            payload_has_intra,
        )

        if bytes(data[:4]) != b"\x00\x00\x01\xBA":
            raise ValueError("at_time needs an MPEG-PS byte buffer")
        buf = Buffer(io.BytesIO(bytes(data)))
        buf.set_load_callback(buf.load_reader_callback)
        dmx = Demux(buf)
        header_end = buf.tell()   # absolute position after pack+system
        dmx.get_start_time(PACKET_VIDEO_1)
        # Anchor on the raw first PTS (the reference demuxer's own seek
        # anchor, demux.go:216-254): GOP boundaries sit at
        # first_pts + k*gop, so targets like t=6.0 pick the intended GOP.
        anchor = dmx.first_pts.get(PACKET_VIDEO_1, 0.0)
        target = anchor + max(0.0, seek_time)

        # Leading video ES bytes (hold the sequence header): bounded
        # packet reads from the stream head.
        dmx._buffer_seek(header_end)
        es_head = b""
        while len(es_head) < 4096 and \
                buf.find_start_code(PACKET_VIDEO_1) != -1:
            packet = dmx._decode_packet(PACKET_VIDEO_1)
            if packet is None:
                break
            es_head += bytes(packet.data)

        # Byte-rate estimate for the jump (duration's tail scan is
        # itself O(tail windows), demux.py:get_duration).
        import math
        dmx.get_duration(PACKET_VIDEO_1)
        span = dmx.last_pts.get(PACKET_VIDEO_1, PACKET_INVALID_TS) - anchor
        byte_rate = (len(data) / span) if span > 0 else float("nan")

        scan_bytes = len(es_head)
        best_off = -1
        best_pts = PACKET_INVALID_TS
        margin = 2.0
        for _attempt in range(8):
            from_head = (not math.isfinite(byte_rate)) or \
                target - margin <= anchor
            if from_head:
                jump = header_end
            else:
                jump = min(int((target - margin - anchor) * byte_rate),
                           max(len(data) - 256, header_end))
            dmx._buffer_seek(jump)
            while buf.find_start_code(PACKET_VIDEO_1) != -1:
                packet_start = buf.tell() - 4   # the 00 00 01 E0 itself
                packet = dmx._decode_packet(PACKET_VIDEO_1)
                if packet is None:
                    break
                if packet.pts == PACKET_INVALID_TS:
                    continue
                if payload_has_intra(packet.data, packet.length) and \
                        (best_off < 0 or
                         best_pts <= packet.pts <= target) and \
                        (from_head or packet.pts <= target):
                    # latest intra at/before the target; from the stream
                    # head, a too-early target clamps to the stream's
                    # first intra (mid-stream jumps must not clamp to a
                    # LATER intra — they widen backwards instead)
                    best_off, best_pts = packet_start, packet.pts
                if best_off >= 0 and packet.pts > target + REORDER_WINDOW:
                    # past the reorder window with an intra in hand:
                    # nothing better ahead (without one, keep scanning —
                    # the first intra may come long after the first PTS)
                    break
            scan_bytes += buf.tell() - jump
            if best_off >= 0 or from_head:
                break
            margin *= 4   # overshot every intra <= target: widen back

        if best_off < 0:
            return None
        # Seed the clip with the sequence header: mid-stream tune-in
        # needs it, and this framework supports streams that carry it
        # only at the start (the MPEG class keeps it across rewind —
        # video.go:195-201 — so its seek doesn't need this).
        seq = _pes_packet(PACKET_VIDEO_1, _extract_sequence_header(es_head))
        clip = bytes(data[:header_end]) + seq + bytes(data[best_off:])
        dec = cls(clip, **kwargs)
        dec._drop_leading_b = True
        dec._seek_scan_bytes = scan_bytes
        return dec, best_pts

    def _make_native(self, data: bytes):
        """Choose the container (PS pipeline vs raw ES parser) from the
        first bytes and create the native parser; in streaming mode the
        choice waits until 4 bytes have arrived."""
        if self._streaming:
            self._prefix += data
            if len(self._prefix) < 4:
                return
            data, self._prefix = self._prefix, b""
        if data[:4] == b"\x00\x00\x01\xBA":
            # MPEG-PS container: the fully-native pipeline (demux +
            # ES parse in C++) exposes the same blob contract.
            self.native = self._native_mod.NativePipeline()
        else:
            self.native = self._native_mod.NativeVideoParser()
        self.native.feed(data)
        if not self._streaming:
            self.native.signal_end()

    def feed(self, data: bytes) -> None:
        """Streaming mode: push more source bytes (ES or PS)."""
        assert self._streaming, "construct with streaming=True to feed"
        if self.video is not None:
            self.video.buf.write(data)
        elif self.native is None:
            self._make_native(bytes(data))
        else:
            self.native.feed(data)

    def signal_end(self) -> None:
        """Streaming mode: the source is exhausted (enables the final
        partial-picture parse and the end-of-stream flush frame)."""
        self._ended = True
        if self.video is not None:
            self.video.buf.signal_end()
        elif self.native is not None:
            self.native.signal_end()

    @property
    def needs_input(self) -> bool:
        """Streaming mode: True while feed() can still unblock decode —
        disambiguates decode_window() returning [] ('need more bytes')
        from end of stream after signal_end."""
        return self._streaming and not self._ended

    @property
    def geom(self) -> FrameGeometry:
        if self.native is None and self.video is None:
            if self._cached_geom is not None:
                return self._cached_geom
            raise RuntimeError("decoder closed" if self._closed
                               else "decoder has no parser")
        return self.native.geom() if self.native is not None \
            else self.video.geom

    def _has_header(self) -> bool:
        if self.video is not None:
            return self.video.has_header()
        return self.native is not None and self.native.has_header()

    def _stream_ended(self) -> bool:
        if self.native is not None:
            return self._ended
        # Push-fed buffers can't infer EOS after compaction (total_size
        # vs shrunken data), so the streaming flag is authoritative.
        return self._ended or self.video.buf.has_ended()

    def _ensure_device_state(self, caps=None):
        import jax.numpy as jnp
        if caps is None:
            caps = (self._km, self._ke) if self.transport == "blob" else None
        if self._scan is None or self._scan_caps != caps:
            if self.transport == "blob":
                self._scan = make_blob_scan_decoder(
                    self.geom, self.window, caps[0], caps[1],
                    emit_rgba=self.emit_rgba)
            else:
                self._scan = make_dense_scan_decoder(
                    self.geom, emit_rgba=self.emit_rgba)
            self._scan_caps = caps
        if self._carry is None:
            # Three DISTINCT buffers: the scan donates its carry, and XLA
            # rejects donating one buffer twice.
            self._carry = tuple(
                jnp.zeros(self.geom.total_size, jnp.uint8)
                for _ in range(3))

    def parse_window(self):
        """Parse up to `window` picture plans from the stream."""
        plans = []
        while len(plans) < self.window:
            item = self.video.parse_next_plan()
            if item is None:
                break
            plans.append(item)
        return plans

    def _alloc_window_blob(self):
        """Allocate or recycle a window blob for the current pool
        buckets; returns (blob, field views, (hw_nm, hw_ne) pool
        high-water marks).  Fresh buffers are uninitialized with full
        high-water marks — the native window call writes every field
        byte itself; recycled buffers skip re-padding the tail beyond
        their previous fill (blob_window_impl zeroes record tails and
        unused picture slots off the GIL either way)."""
        key = (self._km, self._ke)
        while True:
            try:
                blob, bkey, hwm = self._blob_free.pop()
            except IndexError:
                break
            if bkey == key:
                return blob, blob_views(blob, self.geom, self.window,
                                        self._km, self._ke), hwm
            # stale capacity bucket: drop the buffer
        _, total = blob_layout(self.geom, self.window, self._km, self._ke)
        blob = np.empty(total, np.uint8)
        return blob, blob_views(blob, self.geom, self.window,
                                self._km, self._ke), key

    def _reap_blobs(self):
        """Move inflight blobs whose consuming window completed (its
        output gate array is ready) onto the free list (dispatch thread
        only).  A stalled window never blocks: not-yet-ready buffers
        stay inflight, oldest dropped past a cap so a link outage
        cannot grow host/device memory unboundedly."""
        dq = self._blob_inflight
        while dq:
            gate, blob, bkey, hwm = dq[0]
            if not gate.is_ready():
                if len(dq) > 4:
                    dq.popleft()   # drop the reference, no recycling
                    continue
                break
            dq.popleft()
            if len(self._blob_free) < 3:
                self._blob_free.append((blob, bkey, hwm))

    def _native_window_blob(self):
        """Parse up to `window` pictures in one native call per window
        (plus one per pool-bucket growth); returns
        (blob | None, types, (nm, ne) fill level)."""
        w = self.window
        types = np.zeros(w, np.int32)
        blob, v, hwm = self._alloc_window_blob()
        w_done = nm = ne = 0
        prev_m = prev_e = 0   # delta-chain tails, carried across growth
        # Worst-case hop-record count for the whole window: total index
        # gap <= the window's dense span, one hop per 0xFFFF of gap.
        # Growth sizes buckets with this slack so the native call's
        # conservative per-picture capacity bound always fits after one
        # growth (blob_window_impl checks records + a prev-aware bound).
        hop_slack = (w * self.geom.mb_size * 6 * 64 >> 16) + w + 2
        while True:
            n, nm, ne, pending, prev_m, prev_e = self.native.blob_window(
                w_done, w, self._km, self._ke, nm, ne,
                v["main_rec"], v["esc_didx"], v["esc_val"],
                v["mv_h"], v["mv_v"], v["nbcls"], v["mbmisc"],
                v["flags"], types, hw_nm=hwm[0], hw_ne=hwm[1],
                prev_m=prev_m, prev_e=prev_e)
            w_done += n
            if pending == 0 or w_done >= w:
                break
            # Grow the sticky buckets to fit the pending picture, carry
            # the partially-filled window into the new layout.
            cm, ce = self.native.blob_counts()
            old_km, old_ke = self._km, self._ke
            self._km = pool_bucket(nm + cm + hop_slack, self._km)
            self._ke = pool_bucket(max(ne + ce + hop_slack, 1), self._ke)
            old = v
            blob, v, hwm = self._alloc_window_blob()
            for k in old:
                v[k][:old[k].size] = old[k]
            # The copied prefix (a self-contained delta chain) ends in
            # the old pools' zero pad tails — the pad record (delta 0,
            # value 0) is layout-independent — so pads hold up to the
            # old capacities; past them, only the allocated buffer's own
            # mark is guaranteed — the max of the two bounds the
            # unpadded gap.
            hwm = (max(old_km, hwm[0]), max(old_ke, hwm[1]))
        if w_done == 0:
            # Hand the buffer straight back: the 0-picture call still
            # padded [0, hwm) (records start at 0), so the pad promise
            # holds at the same mark — without this, streaming polls
            # with no buffered bytes would drain the free list.
            self._blob_free.append((blob, (self._km, self._ke), hwm))
            return None, [], None
        return blob, [int(t) for t in types[:w_done]], (nm, ne)

    def decode_window(self) -> list[Optional[np.ndarray]]:
        """Parse + reconstruct one window; returns the displayed frames
        (flat uint8 device arrays).  An empty list means end of stream
        (or, in streaming mode, that more bytes are needed) — windows
        whose displays are all absorbed by the reference delay or the
        open-GOP B-drop advance to the next window internally so callers
        can keep treating [] as 'no more output now'."""
        while True:
            out, parsed = self._decode_window_once()
            if out or not parsed:
                return out

    def _parse_stage(self):
        """Parse + pack one window (runs on the prefetch thread when
        enabled).  Returns (blob, plans, types, caps, t_parse, fill);
        caps pins the pool buckets the blob was packed with, so the
        consumer compiles against the right layout even if a later
        window has already grown the sticky buckets; fill is the
        (nm, ne) pool fill level for blob recycling (None when the
        window came from the Python parse path)."""
        import time
        t0 = time.perf_counter()
        fill = None
        if self.native is not None:
            blob, types, fill = self._native_window_blob()
            plans = None
        else:
            plans = self.parse_window()
            types = [t for _, t in plans]
            blob = None
            if plans and self.transport == "blob":
                records = [plan_pool_records(p) for p, _ in plans]
                (mi, _), (ei, _) = _window_records(
                    plans, self.geom.mb_size, records)
                nm = delta_encode(mi)[0].size
                ne = delta_encode(ei)[0].size
                self._km = max(self._km, pool_bucket(nm, _MIN_KM))
                self._ke = max(self._ke, pool_bucket(ne, _MIN_KE))
                blob = pack_plans_blob(plans, self.geom, self.window,
                                       self._km, self._ke, records=records)
        caps = (self._km, self._ke) if self.transport == "blob" else None
        return blob, plans, types, caps, time.perf_counter() - t0, fill

    def _next_parsed(self):
        """The next parsed window — from the prefetch queue (started
        lazily; depth 2) or parsed inline."""
        if not self._prefetch:
            return self._parse_stage()
        import queue
        import threading
        import weakref
        if self._pf_thread is None:
            self._pf_queue = q = queue.Queue(maxsize=2)
            self._pf_stop = stop = []   # shared cell; close() appends

            # The producer must not keep the decoder alive: it holds a
            # weakref and exits when the decoder is collected, so an
            # abandoned prefetch decoder (no close()) costs at most one
            # 0.5 s poll cycle after GC instead of a permanent leak.
            wr = weakref.ref(self)

            def producer():
                while True:
                    dec = wr()
                    if dec is None or stop:
                        return
                    try:
                        item = dec._parse_stage()
                    except BaseException as e:   # noqa: BLE001
                        # Same timeout-and-recheck loop as the normal
                        # puts: a full queue on an abandoned decoder
                        # must not pin this thread (and its windows)
                        # forever.
                        del dec
                        while not (stop or wr() is None):
                            try:
                                q.put(e, timeout=0.5)
                                break
                            except queue.Full:
                                pass
                        return
                    eos = not item[2]
                    del dec   # no strong decoder ref during the put
                    while True:
                        if stop or wr() is None:
                            return
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            pass
                    if eos:   # no types: parse exhausted
                        return

            self._pf_thread = threading.Thread(target=producer,
                                               daemon=True)
            self._pf_thread.start()
        item = self._pf_queue.get()
        if isinstance(item, BaseException):
            # The producer is gone and may have parsed ahead of the
            # failed window: the windows it held are lost, so poison
            # further decode exactly like close() (resuming inline would
            # silently skip pictures against a stale carry).
            self._pf_thread = None
            self._poison()
            raise item
        if not item[2] and self._pf_thread is not None:
            self._pf_thread.join()
            self._pf_thread = None
            # EOS consumed: parse inline from here on (the flush path
            # and any post-EOS polling must not respawn threads).
            self._prefetch = False
        return item

    def close(self) -> None:
        """Abandon the decoder: stop the prefetch thread and end the
        stream.  The producer may have parsed up to 3 windows ahead, so
        decode cannot transparently continue past a close() — further
        decode_window() calls return [] instead of silently skipping
        the discarded windows.  A decoder read to end of stream shuts
        its thread down by itself; close() is for early exits."""
        if self._pf_thread is not None:
            self._pf_stop.append(True)
            import queue
            while self._pf_thread.is_alive():
                try:
                    self._pf_queue.get_nowait()
                except queue.Empty:
                    pass
                self._pf_thread.join(timeout=0.1)
            self._pf_thread = None
        if self._prefetch:
            self._poison()
        self._prefetch = False

    def _poison(self) -> None:
        """Parsed-ahead windows were discarded; poison further decode
        rather than resume with frame gaps + a stale carry.  Geometry is
        cached first so metadata stays readable on a closed decoder."""
        if self.native is not None or self.video is not None:
            try:
                self._cached_geom = self.geom
            except Exception:   # header never arrived
                pass
        self._types = self._types or [0]
        self._has_reference_frame = False
        self.native = None
        self.video = None
        self._closed = True
        self._prefetch = False

    def _decode_window_once(self):
        """One window; returns (displays, pictures_parsed)."""
        if not self._has_header():
            return [], 0

        blob, plans, types, caps, t_parse, fill = self._next_parsed()

        if not types:
            # End of stream: flush the pending reference frame.
            self._ensure_device_state()
            if self._has_reference_frame and self._stream_ended() \
                    and self._types and self._types[-1] != PICTURE_TYPE_B:
                self._has_reference_frame = False
                flush = self._carry[2]   # backward
                if self.emit_rgba:
                    flush = _rgba_converter(self.geom)(flush)
                return [flush], 0
            return [], 0

        import time
        self._ensure_device_state(caps)
        t0 = time.perf_counter()
        if self.transport == "blob":
            self._carry, disps = self._scan(self._carry, blob, fill)
            if fill is not None:
                split = blob_split(self.geom, self.window, *caps)
                kt = min(pool_bucket(max(fill[0], 1), _MIN_KM), caps[0])
                nbytes = split + 4 * kt   # bytes actually transferred
            else:
                nbytes = blob.nbytes
            # Recycle the host blob once this window's OUTPUT is ready:
            # the scan cannot complete without having fully read the
            # blob.  (is_ready on the device_put result itself is NOT a
            # sufficient barrier — the CPU backend consumes the host
            # buffer lazily from inside the jit, measurably after the
            # input array reports ready.)
            self._reap_blobs()
            if fill is not None:
                import jax
                leaf = jax.tree_util.tree_leaves(disps)[0]
                # Gate on a 1-element derived slice, not the display
                # array itself: the slice completes only after the scan
                # output exists, but holding it in the inflight deque
                # does not pin whole windows of frames on a slow link.
                gate = leaf[(0,) * (leaf.ndim - 1) + (slice(0, 1),)]
                self._blob_inflight.append((gate, blob, caps, fill))
        else:
            stacked = stack_plans(plans, self.geom, self.window)
            self._carry, disps = self._scan(self._carry, stacked)
            nbytes = sum(a.nbytes for a in stacked.values())
        t_disp = time.perf_counter() - t0

        if self.stats is not None:
            self.stats.record_window(len(types), nbytes, t_parse, t_disp)

        out = []
        for i, ptype in enumerate(types):
            self._types.append(ptype)
            if ptype != PICTURE_TYPE_B:
                self._refs_parsed += 1
            if ptype == PICTURE_TYPE_B:
                # Mid-stream tune-in (at_time): B pictures before the
                # second reference frame predict from the pre-cut frame
                # the clip doesn't have — drop them (open-GOP artifact).
                if not (self._drop_leading_b and self._refs_parsed < 2):
                    out.append(disps[i])
            elif self._has_reference_frame:
                out.append(disps[i])
            else:
                self._has_reference_frame = True
        return out, len(types)

    def decode_all(self) -> list:
        """Decode the whole stream; returns flat frame buffers in display
        order."""
        frames = []
        while True:
            got = self.decode_window()
            if not got:
                break
            frames.extend(got)
        return frames
