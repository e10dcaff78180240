"""Framework configuration.

Mirrors the reference's three config mechanisms (SURVEY §5 config row):
its `noasm` build tag becomes the `backend`/`parser` selectors,
`BufferSize` is carried over verbatim, and the runtime setters (audio
format/stream/lead time, loop, no-delay, probe size) live on the decoder
objects as in the reference.  Everything here has a working default;
pass a Config to `MPEG`, `Video`, `Audio` or `BatchVideoDecoder` to
override their defaults in one place (explicit keyword arguments still
win over the Config).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Config:
    # Compute backend for the per-frame decode paths:
    #   "jax"   — device dispatch per picture/frame (the default JAX
    #             device)
    #   "numpy" — host scalar-exact oracle (the `noasm` analog)
    backend: str = "jax"

    # Host parser: "native" (C++) when available, else "python";
    # "auto" picks native when the shared object builds/loads.
    parser: str = "auto"

    # Batched decode (parallel/) knobs.
    window: int = 32          # pictures per device dispatch
    transport: str = "blob"   # "blob" (window pool) | "dense" (oracle)

    # Buffer refill chunk (reference BufferSize, buffer.go:8-11).
    buffer_size: int = 128 * 1024

    # Audio defaults (reference SetAudioFormat/SetAudioLeadTime).
    audio_format: int = 0        # AudioFormat.F32N
    audio_lead_time: float = 0.0


DEFAULT = Config()
