"""Batched MP2 decode: many frames of synthesis per device dispatch.

Host parse (native C++ when available) emits subband sample tensors; the
device runs one (frames*36)-step filterbank scan per window, carrying the
V ring buffers.  Output normalization stays on host for the exact IEEE
division (see ops/filterbank.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops import filterbank


class BatchAudioDecoder:
    """Throughput-oriented MP2 decoder: bytes in, PCM windows out."""

    def __init__(self, data: bytes, window: int = 32,
                 use_native: bool = None, streaming: bool = False,
                 stats=None, out_format: str = "f32",
                 out_device: bool = False, prefetch: bool = False):
        """streaming: bytes arrive incrementally via feed(); call
        signal_end() at source exhaustion (decode_window returns the
        frames buffered so far in the meantime).
        stats: an optional utils.profiling.DecodeStats populated per
        window (parse/synthesis timing, h2d bytes, samples).
        out_format: "f32" (normalized interleaved float32 — the golden
        contract; normalization divides on host for the exact IEEE
        quotient) or "s16" (interleaved int16 quantized ON DEVICE with
        the bit-exact constant-divisor kernel, halving the d2h bytes —
        matches Samples.s16 / the reference's AudioS16 lane,
        audio.go:401-407, exactly).
        out_device: decode_window returns device-resident jax arrays
        instead of numpy — no d2h at all; downstream device consumers
        (mixing, resampling, encoding) read PCM straight from HBM.
        window: frames per device dispatch.  Throughput scales with it
        until the host parse caps out (dispatch latency amortizes);
        latency-sensitive callers keep it small.
        Both formats stay bit-exact: the f32 normalization uses the
        same exact-IEEE constant-divisor kernel as the S16 lane."""
        if out_format not in ("f32", "s16"):
            raise ValueError(f"unknown out_format {out_format!r}")
        self.out_format = out_format
        self.out_device = out_device
        window = max(4, window - window % 4)   # parallel path needs 4n frames
        from .. import native as native_mod
        if use_native is None:
            use_native = native_mod.available()
        self.window = window
        self.native = None
        self._pipeline = None
        self._py = None
        self._native_mod = native_mod
        self._streaming = streaming
        self._use_native = use_native
        self._prefix = b""
        if use_native:
            if data or not streaming:
                self._make_native(bytes(data))
        else:
            import io
            from ..audio import Audio
            from ..buffer import Buffer
            if streaming:
                buf = Buffer(None)
                if data:
                    buf.write(bytes(data))
            else:
                buf = Buffer(io.BytesIO(bytes(data)))
                buf.set_load_callback(buf.load_reader_callback)
            self._py = Audio(buf, backend="numpy")

        self._synth = None
        self._v = None
        self._v_pos = None
        self._ended = not streaming
        self._pending: list = []
        self.stats = stats

        # Prefetch: a producer thread parses the next window while the
        # consumer synthesizes the current one (ctypes parse releases
        # the GIL; mirrors BatchVideoDecoder's prefetch semantics:
        # weakref producer so an abandoned decoder is collectable,
        # in-band exception delivery so already-parsed windows drain
        # first, poisoning after close() or a producer error).
        self._prefetch_q = None
        self._prefetch_done = False
        self._closed = False
        if prefetch:
            if streaming:
                raise ValueError("prefetch requires a complete source "
                                 "(streaming=False)")
            import queue as queue_mod
            import threading
            import weakref
            self._prefetch_q = q = queue_mod.Queue(maxsize=2)
            self._prefetch_stop = stop = []   # shared cell; close() appends
            # The producer must not keep the decoder alive: it holds a
            # weakref and exits when the decoder is collected, so an
            # abandoned prefetch decoder (no close()) costs at most one
            # 0.5 s poll cycle after GC instead of a permanent leak.
            wr = weakref.ref(self)

            def producer():
                import time
                while True:
                    dec = wr()
                    if dec is None or stop:
                        return
                    try:
                        t0 = time.perf_counter()
                        frames = []
                        while len(frames) < dec.window:
                            f = dec._parse_frame()
                            if f is None:
                                break
                            frames.append(f)
                        if dec.stats is not None:
                            dec.stats.host_seconds += \
                                time.perf_counter() - t0
                    except BaseException as e:   # noqa: BLE001
                        # In-band (good windows drain first), with the
                        # same timeout-and-recheck loop as the normal
                        # puts: a full queue on an abandoned decoder
                        # must not pin this thread forever.
                        del dec
                        while not (stop or wr() is None):
                            try:
                                q.put(e, timeout=0.5)
                                break
                            except queue_mod.Full:
                                pass
                        return
                    eos = len(frames) < dec.window
                    del dec   # no strong decoder ref during the puts
                    for item in ([frames] if frames else []) + \
                            ([None] if eos else []):
                        while True:
                            if stop or wr() is None:
                                return
                            try:
                                q.put(item, timeout=0.5)
                                break
                            except queue_mod.Full:
                                pass
                    if eos:
                        return

            self._prefetch_t = threading.Thread(target=producer,
                                                daemon=True)
            self._prefetch_t.start()

    def close(self) -> None:
        """Stop the prefetch producer and poison further decode (any
        prefetched-but-unconsumed windows are discarded, so resuming
        would skip frames — decode_window returns None from now on)."""
        self._closed = True
        if self._prefetch_q is not None:
            self._prefetch_stop.append(True)
            import queue as queue_mod
            import time
            while self._prefetch_t.is_alive():   # unblock stuck put()s
                try:
                    self._prefetch_q.get_nowait()
                except queue_mod.Empty:
                    time.sleep(0.01)
            while True:   # drop remaining windows + end sentinel
                try:
                    self._prefetch_q.get_nowait()
                except queue_mod.Empty:
                    break

    def _make_native(self, data: bytes):
        if self._streaming:
            self._prefix += data
            if len(self._prefix) < 4:
                return
            data, self._prefix = self._prefix, b""
        if data[:4] == b"\x00\x00\x01\xBA":
            # MPEG-PS container: fully-native demux + MP2 parse.
            self._pipeline = self._native_mod.NativePipeline()
            target = self._pipeline
        else:
            self.native = self._native_mod.NativeAudioParser()
            target = self.native
        target.feed(data)
        if not self._streaming:
            target.signal_end()

    def feed(self, data: bytes) -> None:
        """Streaming mode: push more source bytes (MP2 ES or PS)."""
        assert self._streaming, "construct with streaming=True to feed"
        if self._py is not None:
            self._py.buf.write(data)
        elif self.native is None and self._pipeline is None:
            self._make_native(bytes(data))
        else:
            (self._pipeline or self.native).feed(data)

    def signal_end(self) -> None:
        self._ended = True
        if self._py is not None:
            self._py.buf.signal_end()
        elif self._pipeline is not None or self.native is not None:
            (self._pipeline or self.native).signal_end()

    @property
    def needs_input(self) -> bool:
        """Streaming mode: True while feed() can still unblock decode —
        disambiguates decode_window() returning None ('need more bytes'
        vs end of stream after signal_end)."""
        return self._streaming and not self._ended

    @property
    def samplerate(self) -> int:
        if self._pipeline is not None:
            return self._pipeline.samplerate
        if self.native is not None:
            self.native.has_header()
            return self.native.samplerate
        if self._py is None:
            return 0   # streaming: container not known yet (< 4 bytes fed)
        return self._py.samplerate()

    @property
    def channels(self) -> int:
        if self._pipeline is not None:
            return self._pipeline.channels
        if self.native is not None:
            self.native.has_header()
            return self.native.channels
        if self._py is None:
            return 0   # streaming: container not known yet
        return self._py.get_channels()

    def _parse_frame(self) -> Optional[np.ndarray]:
        if self._pipeline is not None:
            return self._pipeline.parse_next_audio_frame()
        if self.native is not None:
            return self.native.parse_next_frame()
        if self._py is None:
            return None   # streaming: container not known yet
        a = self._py
        if a.next_frame_data_size == 0:
            a.next_frame_data_size = a._decode_header()
        if a.next_frame_data_size == 0 or \
                not a.buf.has(a.next_frame_data_size << 3):
            return None
        out = a._parse_frame()
        a.next_frame_data_size = 0
        return out

    def decode_window(self) -> Optional[np.ndarray]:
        """Decode up to `window` frames; returns interleaved samples
        [n_frames * 2304] (float32, or int16 with out_format="s16"), or
        None at end of stream (or, in streaming
        mode, when a full window hasn't accumulated yet — the V-ring
        carry advances in whole windows, so partial windows only flush
        after signal_end)."""
        import jax.numpy as jnp
        import time

        if self._closed:
            return None
        if self._prefetch_q is not None:
            if self._prefetch_done:
                return None
            frames = self._prefetch_q.get()
            if isinstance(frames, BaseException):
                # Producer failed: poison like close() — windows the
                # producer parsed past the failure are lost, resuming
                # would skip frames.  (Good windows queued BEFORE the
                # failure were delivered in order first.)
                self._closed = True
                raise frames
            if frames is None:
                self._prefetch_done = True
                return None
        else:
            t_parse = time.perf_counter()
            while len(self._pending) < self.window:
                f = self._parse_frame()
                if f is None:
                    break
                self._pending.append(f)
            t_parse = time.perf_counter() - t_parse
            if self.stats is not None:
                self.stats.host_seconds += t_parse
            if not self._pending:
                return None
            if len(self._pending) < self.window and not self._ended:
                return None   # streaming: wait for a whole window
            frames, self._pending = self._pending, []

        if self._synth is None:
            # Parallel (scan-free) synthesis: all DCTs at once, windowed
            # MAC as strided tap slices — bit-exact vs the per-step scan.
            if self.out_format == "s16":
                self._synth = filterbank.make_synthesize_parallel_s16_jax()
            else:
                self._synth = filterbank.make_synthesize_parallel_jax()
            self._v = jnp.zeros((15, 2, 64), jnp.float32)   # block history

        n = len(frames)
        samples = np.zeros((self.window, 36, 2, 32), np.int32)
        samples[:n] = frames
        # stats.detailed: split the device leg into h2d / dispatch / d2h
        # with explicit syncs (attribution mode — the extra barriers
        # serialize the overlap the default path keeps, so enable it
        # only when the split itself is the measurement).
        detailed = self.stats is not None and self.stats.detailed
        t0 = time.perf_counter()
        xs = jnp.asarray(samples.reshape(-1, 2, 32))
        if detailed:
            import jax
            jax.block_until_ready(xs)
            t1 = time.perf_counter()
            self.stats.h2d_seconds += t1 - t0
        out, self._v = self._synth(xs, self._v)
        if detailed:
            import jax
            jax.block_until_ready(out)
            t2 = time.perf_counter()
            self.stats.dispatch_seconds += t2 - t1
        if self.out_format == "s16":
            if self.out_device:
                pcm = out[:n * 2304]   # device slice, no d2h
            else:
                # Quantized + interleaved on device; d2h is int16.
                pcm = np.asarray(out)[:n * 2304]
        elif self.out_device:
            u = out.reshape(self.window, 36, 2, 32)
            pcm = filterbank.make_finalize_jax()(u).reshape(-1)[:n * 2304]
        else:
            u = np.asarray(out).reshape(self.window, 36, 2, 32)[:n]
            pcm = filterbank.finalize_np(u).reshape(-1)
        if detailed:
            self.stats.d2h_seconds += time.perf_counter() - t2
        if self.stats is not None:
            self.stats.samples += n * 1152
            self.stats.transfer_bytes += samples.nbytes
            self.stats.device_seconds += time.perf_counter() - t0
        return pcm

    def decode_all(self) -> np.ndarray:
        """Decode the whole stream to interleaved PCM (dtype per
        out_format; a device array when out_device=True)."""
        chunks = []
        while True:
            pcm = self.decode_window()
            if pcm is None:
                break
            chunks.append(pcm)
        dtype = np.int16 if self.out_format == "s16" else np.float32
        if self.out_device:
            import jax.numpy as jnp
            return jnp.concatenate(chunks) if chunks \
                else jnp.zeros(0, dtype)
        return np.concatenate(chunks) if chunks else np.zeros(0, dtype)
