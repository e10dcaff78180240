"""Many-streams-per-chip video decode through ONE global record chain.

The serving shape for dense multi-tenant decode (many 1080p streams
per card): N independent streams decode in lockstep, each
round parsing `window` pictures per stream.  Instead of N per-stream
window blobs — whose power-of-two record buckets must each cover the
DENSEST window any stream might produce (at window=2 on 1080p GOP
content, 72% of those bytes were zero pad slack) — every stream fills
disjoint picture slots of one logical N*window-picture window: stream s
owns slots [s*window, (s+1)*window), which the native window ABI
supports directly via its start_pic argument.  The round then ships

- one fixed metadata+escape block (per-MB motion/class/flags for all
  streams), and
- ONE power-of-two bucket of the SUM of record fills (the delta chain
  runs across stream boundaries; tails are zero pads),

and the device rebuilds every coefficient of every stream with one
cumsum + one sorted scatter into a [N*window*mb*6*64] dense tensor —
58 -> 24 MB/round at 64x1080p window-2 vs the per-stream layouts, and
one big scatter instead of 64 small ones.  Reconstruction runs as
`lax.map` over chunks of a `vmap`'d per-stream scan so the temporaries
of very wide batches stay inside HBM.

Constraint: the global dense span N*window*mb*6*64 must stay below
2^31 (the index chain decodes through an int32 cumsum) — at 1080p that
is ~685 pictures per round (e.g. 64 streams x window 8).

Per-stream output semantics mirror BatchVideoDecoder / the reference
decoder exactly: 1-frame reference delay, open-GOP handling, and an
end-of-stream flush of the pending reference frame.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np

from ..ops.video_recon import FrameGeometry
from ..tables import PICTURE_TYPE_B
from .batch import (
    _MIN_KE, _MIN_KM, blob_split, densify_split_jax, make_scan_step,
    pool_bucket, split_views, unpack_blob_meta,
)


@functools.lru_cache(maxsize=None)
def make_global_scan_decoder(geom: FrameGeometry, n_streams: int,
                             window: int, kmg: int, keg: int,
                             chunks: int, emit_rgba: bool = False):
    """(carry [S,total] x3, meta_esc bytes, main_rec bytes) -> (carry,
    displays [S, window, frame]).  Two executables like the single-
    stream window decoder (standalone scatter, then the scatter-free
    chunked scan); the main_rec input may be any zero-padded prefix
    bucket of the layout's main lane."""
    import jax
    import jax.numpy as jnp

    gw = n_streams * window
    mb = geom.mb_size
    step = make_scan_step(geom, emit_rgba)

    @jax.jit
    def densify(meta_esc, main_part):
        return densify_split_jax(meta_esc, main_part, geom, gw, keg)

    def scan_one(carry, xs):
        return jax.lax.scan(step, carry, xs)

    @functools.partial(jax.jit, donate_argnums=0)
    def scan_stage(carry, meta_esc, dense):
        xs = unpack_blob_meta(meta_esc, geom, gw, kmg, keg)
        xs["coeffs"] = dense.reshape(gw, mb, 6, 64)
        per = n_streams // chunks
        cs = tuple(c.reshape(chunks, per, -1) for c in carry)
        xs = {k: v.reshape((chunks, per, window) + v.shape[1:])
              for k, v in xs.items()}

        def chunk(args):
            c0, c1, c2, x = args
            (d0, d1, d2), disps = jax.vmap(scan_one)((c0, c1, c2), x)
            return (d0, d1, d2, disps)

        d0, d1, d2, disps = jax.lax.map(chunk, (cs[0], cs[1], cs[2], xs))
        return (tuple(d.reshape(n_streams, -1) for d in (d0, d1, d2)),
                disps.reshape(n_streams, window, -1))

    def decode(carry, meta_esc_np, main_part_np):
        import jax as _jax
        meta_esc = _jax.device_put(meta_esc_np)
        main_part = _jax.device_put(main_part_np)
        return scan_stage(carry, meta_esc, densify(meta_esc, main_part))

    return decode


class _Slot:
    """One recycled host buffer pair + its pad high-water marks."""

    __slots__ = ("meta", "main", "views", "types", "hwm", "gate", "evt")

    def __init__(self, geom, gw, kmg, keg):
        import threading
        self.meta = np.empty(blob_split(geom, gw, kmg, keg), np.uint8)
        self.main = np.empty(4 * kmg, np.uint8)
        self.views = split_views(self.meta, self.main, geom, gw, kmg, keg)
        self.types = np.empty(gw, np.int32)
        self.hwm = (kmg, keg)   # fresh: pad the full capacity once
        self.gate = None        # scan-output slice of the round that
                                # consumed this slot (device read proof)
        # Hand-back event: cleared when the filler hands the slot to the
        # consumer, set by the consumer AFTER it assigned the gate (or
        # decided not to dispatch).  Without it, a prefetching filler
        # could observe gate=None while the consumer is still
        # dispatching and refill under a lazy device read.
        self.evt = threading.Event()
        self.evt.set()


class MultiStreamVideoDecoder:
    """Lockstep decoder for N independent video sources on one chip.

    `sources` is a list of byte buffers (raw MPEG-1 ES or MPEG-PS,
    sniffed per stream like BatchVideoDecoder).  decode_window() parses
    `window` pictures from EVERY stream, reconstructs them in one
    global dispatch, and returns a list of per-stream display-frame
    lists (flat uint8 device arrays; [] for a stream with no output
    this round; the decoder returns None when every stream is done).

    chunks: how many lax.map chunks the stream batch splits into on
    device (HBM working-set control; default ~32 streams per chunk).
    """

    def __init__(self, sources: List[bytes], window: int = 2,
                 chunks: int = None, pool_buckets: tuple = None,
                 emit_rgba: bool = False, prefetch: bool = False):
        from .. import native as native_mod

        if not native_mod.available():
            raise RuntimeError("MultiStreamVideoDecoder needs the native "
                               "parser (global-chain fills are a native-"
                               "window-ABI feature)")
        if not sources:
            raise ValueError("need at least one source")
        self.n = len(sources)
        self.window = window
        self.emit_rgba = emit_rgba
        self.parsers = []
        for data in sources:
            data = bytes(data)
            p = native_mod.NativePipeline() \
                if data[:4] == b"\x00\x00\x01\xBA" \
                else native_mod.NativeVideoParser()
            p.feed(data)
            p.signal_end()
            if not p.has_header():
                raise ValueError("source without a sequence header")
            self.parsers.append(p)
        self.geom = self.parsers[0].geom()
        for p in self.parsers[1:]:
            if p.geom() != self.geom:
                raise ValueError("all sources must share one geometry "
                                 "(one compiled program per geometry)")
        if chunks is None:
            # Smallest divisor of n whose chunks hold <= ~32 streams;
            # awkward counts (primes > 32) fall back to ONE wide chunk
            # — a single vmap over all streams beats n serial chunks of
            # one stream, which is what divisor-hunting would pick.
            ok = [c for c in range(1, self.n + 1)
                  if self.n % c == 0 and self.n // c <= 32]
            chunks = min(ok)
            if chunks > 1 and self.n // chunks < 8:
                chunks = 1
        else:
            while self.n % chunks:
                chunks += 1   # lax.map needs equal chunks
        self.chunks = chunks
        gw = self.n * window
        assert gw * self.geom.mb_size * 6 * 64 < 2 ** 31, \
            "global dense span overflows the int32 index cumsum; " \
            "lower window or split the stream set"
        km, ke = pool_buckets or (_MIN_KM, _MIN_KE)
        self._kmg = pool_bucket(km, _MIN_KM)
        self._keg = pool_bucket(max(ke, 1), _MIN_KE)
        self._slots = None        # lazy: sized at first (possibly grown)
        self._slot_i = 0
        self._carry = None
        self._decode = None
        self._caps = None
        # Per-stream display bookkeeping (reference-delay semantics).
        self._has_ref = [False] * self.n
        self._last_type = [0] * self.n
        self._flushed = [False] * self.n
        # prefetch: parse the next global window on a background thread
        # while the device consumes the current one (same discipline as
        # BatchVideoDecoder: the double-buffered slots already gate
        # reuse on the consuming round's output, so the producer can
        # run exactly one window ahead).
        self._prefetch = prefetch
        self._pf_queue = None
        self._pf_thread = None
        self._pf_stop = None
        self._closed = False

    # -- host fill -----------------------------------------------------------

    def _fill(self):
        """Parse one global window; returns (slot, types [S, W], nm,
        caps) — caps pins the (kmg, keg) layout the window was packed
        with, so a prefetching consumer compiles against the right
        shapes even if a LATER window has already grown the sticky
        buckets.
        Pool growth mid-window copies the partially-filled buffers into
        the grown layout and RESUMES (the parsers have consumed those
        pictures; only the pending picture is re-emitted)."""
        import jax

        gw = self.n * self.window
        if self._slots is None:
            self._slots = [_Slot(self.geom, gw, self._kmg, self._keg)
                           for _ in range(2)]
            self._slot_i = 0
        slot = self._slots[self._slot_i]
        # Reuse barrier, two parts: wait until the consumer HANDED the
        # slot back (evt — assigned the gate or skipped the dispatch),
        # then block on the gate itself (a 1-element slice of the scan
        # output that consumed the slot: the device must have fully
        # read these buffers before the parser overwrites them — the
        # input array's own readiness is not a safe barrier on the CPU
        # backend).
        while not slot.evt.wait(timeout=0.5):
            if self._closed:
                raise RuntimeError("decoder closed")
        if slot.gate is not None:
            jax.block_until_ready(slot.gate)
            slot.gate = None
        v = slot.views
        nm = ne = pm = pe = 0
        for s, p in enumerate(self.parsers):
            w_done = s * self.window
            end = (s + 1) * self.window
            while w_done < end:
                n, nm, ne, pending, pm, pe = p.blob_window(
                    w_done, end, self._kmg, self._keg, nm, ne,
                    v["main_rec"], v["esc_didx"], v["esc_val"],
                    v["mv_h"], v["mv_v"], v["nbcls"], v["mbmisc"],
                    v["flags"], slot.types,
                    hw_nm=0, hw_ne=0,   # one numpy pad below instead
                    prev_m=pm, prev_e=pe)
                w_done += n
                if pending == 0:
                    break   # stream dry (tail slots zeroed by impl)
                # Global pool overflow: grow the sticky buckets, copy
                # the partial window into the new layout (the delta
                # chain is self-contained), resume at this parser.
                cm, ce = p.blob_counts()
                span = gw * self.geom.mb_size * 6 * 64
                slack = (span >> 16) + gw + 2
                self._kmg = pool_bucket(nm + cm + slack, self._kmg)
                self._keg = pool_bucket(ne + ce + slack, self._keg)
                old_types = slot.types
                old_v = v
                for other in self._slots:
                    while not other.evt.wait(timeout=0.5):
                        if self._closed:
                            raise RuntimeError("decoder closed")
                    if other.gate is not None:
                        jax.block_until_ready(other.gate)
                self._slots = [_Slot(self.geom, gw, self._kmg, self._keg)
                               for _ in range(2)]
                self._slot_i = 0
                slot = self._slots[0]
                v = slot.views
                for k in old_v:
                    v[k][:old_v[k].size] = old_v[k]
                slot.types[:] = old_types
                # Copied prefixes end in the OLD layout's zero pad
                # tails; beyond them the fresh-slot full hwm pads below.
        # Zero the pad tails down from the previous fill (or the full
        # capacity for a fresh slot) — the prefix-transfer contract
        # needs [fill, bucket) to be zero records.
        hwm_m, hwm_e = slot.hwm
        if hwm_m > nm:
            slot.main[4 * nm:4 * hwm_m] = 0
        if hwm_e > ne:
            v["esc_didx"][ne:hwm_e] = 0
            v["esc_val"][ne:hwm_e] = 0
        slot.hwm = (nm, ne)
        self._slot_i = (self._slot_i + 1) % len(self._slots)
        slot.evt.clear()   # handed out; the consumer sets it back after
                           # assigning the gate (or skipping dispatch)
        # types is COPIED out: the consumer reads it on the host after
        # it hands the slot back, at which point a prefetch producer
        # may already be refilling the slot's buffers.
        return (slot, slot.types.reshape(self.n, self.window).copy(), nm,
                (self._kmg, self._keg))

    # -- device round --------------------------------------------------------

    def _ensure_device(self, caps):
        import jax.numpy as jnp
        if self._decode is None or self._caps != caps:
            self._decode = make_global_scan_decoder(
                self.geom, self.n, self.window, caps[0], caps[1],
                self.chunks, emit_rgba=self.emit_rgba)
            self._caps = caps
        if self._carry is None:
            self._carry = tuple(
                jnp.zeros((self.n, self.geom.total_size), jnp.uint8)
                for _ in range(3))

    def _next_filled(self):
        """The next parsed global window — prefetched or inline."""
        if not self._prefetch:
            return self._fill()
        import queue
        import threading
        import weakref
        if self._pf_thread is None:
            self._pf_queue = q = queue.Queue(maxsize=1)
            self._pf_stop = stop = []
            wr = weakref.ref(self)

            def producer():
                while True:
                    dec = wr()
                    if dec is None or stop:
                        return
                    try:
                        item = dec._fill()
                    except BaseException as e:   # noqa: BLE001
                        del dec
                        while not (stop or wr() is None):
                            try:
                                q.put(e, timeout=0.5)
                                break
                            except queue.Full:
                                pass
                        return
                    done = not item[1].any()
                    del dec
                    while True:
                        if stop or wr() is None:
                            return
                        try:
                            q.put(item, timeout=0.5)
                            break
                        except queue.Full:
                            pass
                    if done:   # every stream dry: stop after the flush
                        return

            self._pf_thread = threading.Thread(target=producer,
                                               daemon=True)
            self._pf_thread.start()
        item = self._pf_queue.get()
        if isinstance(item, BaseException):
            self._pf_thread = None
            self._closed = True
            raise item
        if not item[1].any() and self._pf_thread is not None:
            self._pf_thread.join()
            self._pf_thread = None
            self._prefetch = False   # flush/polling continues inline
        return item

    def close(self) -> None:
        """Stop the prefetch thread (early exits); further
        decode_window() calls return None (the producer may have parsed
        one window ahead — resuming would skip frames)."""
        self._closed = True   # also unsticks evt.wait loops
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
        self._prefetch = False

    def decode_window(self) -> Optional[list]:
        """One lockstep round; None when every stream is exhausted."""
        import jax

        if self._closed:
            return None
        slot, types, nm, caps = self._next_filled()
        self._ensure_device(caps)
        if not types.any():
            slot.evt.set()   # nothing dispatched; slot reusable as-is
            # All streams dry this round: flush pending reference frames.
            out = [[] for _ in range(self.n)]
            any_flush = False
            for s in range(self.n):
                if self._has_ref[s] and not self._flushed[s] and \
                        self._last_type[s] != PICTURE_TYPE_B:
                    frame = self._carry[2][s]
                    if self.emit_rgba:
                        from .batch import _rgba_converter
                        frame = _rgba_converter(self.geom)(frame)
                    out[s] = [frame]
                    self._flushed[s] = True
                    any_flush = True
            return out if any_flush else None

        # At least one stream produced pictures this round.
        kt = min(pool_bucket(max(nm, 1), _MIN_KM), caps[0])
        self._carry, disps = self._decode(
            self._carry, slot.meta, slot.main[:4 * kt])
        # Recycling gate: a 1-element derived slice of this round's
        # output (completes only after the scan read the buffers, but
        # does not pin whole frames).
        leaf = jax.tree_util.tree_leaves(disps)[0]
        slot.gate = leaf[(0,) * (leaf.ndim - 1) + (slice(0, 1),)]
        slot.evt.set()   # gate assigned: the filler may queue behind it

        out = []
        for s in range(self.n):
            frames = []
            for w in range(self.window):
                t = int(types[s, w])
                if t == 0:
                    continue
                self._last_type[s] = t
                if t == PICTURE_TYPE_B:
                    frames.append(disps[s, w])
                elif self._has_ref[s]:
                    frames.append(disps[s, w])
                else:
                    self._has_ref[s] = True
            out.append(frames)
        return out

    def decode_all(self) -> list:
        """Run every stream to completion; returns per-stream frame
        lists in display order."""
        out = [[] for _ in range(self.n)]
        while (got := self.decode_window()) is not None:
            for s, frames in enumerate(got):
                out[s].extend(frames)
        return out
