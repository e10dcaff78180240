"""Multi-stream data parallelism over a device mesh.

Independent MPEG streams are embarrassingly parallel: the stream axis
shards over the mesh with `shard_map`, each device scanning its own
sub-batch of picture plans; the only collective is a `psum` of decoded
pixel/sample counts (a cheap liveness/throughput stat).

This is the multi-device story of the framework (SURVEY §2c): data
parallelism over streams across the devices of one host (a plain 1-D
mesh — the host's cards reach each other all to all), with the host
demux/parse feeding per-device plan shards; multi-host feeds are
parallel/multihost.py.  No cross-stream communication exists in the
problem, so there is nothing for TP/PP to win — scale is breadth of
streams and depth of windows.

Transports mirror parallel/batch.py: the production path ships one
window-pool blob per stream (`make_sharded_blob_decoder`), the dense
dict path stays as the readable oracle (`make_sharded_scan_decoder`).
Audio shards the same way (`make_sharded_audio_synth`): per-stream MP2
subband samples in, PCM out, V-ring history carried per stream.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.video_recon import FrameGeometry
from .batch import make_scan_step, pack_plans_blob, unpack_blob_jax


def make_mesh(devices=None, axis: str = "streams") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def _sharded(decode_one, mesh: Mesh, axis: str):
    """Wrap a per-stream (carry, plans) -> (carry, disps, px) decoder:
    vmap over the local stream shard, psum the decoded-pixel stat."""

    def decode_shard(carry, plans):
        carry, disps, px = jax.vmap(decode_one)(carry, plans)
        total_px = jax.lax.psum(jnp.sum(px), axis)
        return carry, disps, total_px

    def in_spec_of(tree):
        return jax.tree.map(lambda _: P(axis), tree,
                            is_leaf=lambda x: x is None)

    def wrapper(carry, plans):
        sharded = jax.shard_map(
            decode_shard, mesh=mesh,
            in_specs=(in_spec_of(carry), in_spec_of(plans)),
            out_specs=(in_spec_of(carry), P(axis), P()))
        return sharded(carry, plans)

    return jax.jit(wrapper, donate_argnums=0)


def make_sharded_blob_decoder(geom: FrameGeometry, mesh: Mesh, window: int,
                              km: int, ke: int, axis: str = "streams"):
    """Production multi-stream decoder: window-pool blobs [S, bytes]
    sharded over the mesh; carry buffers [S, total_size] donated.

    decode(carry, blobs) -> (carry', displays [S, T, total], decoded_px).

    Compiles the fused unpack+scan in one executable (the single-device
    decoder splits the densify scatter into its own executable; see
    batch.densify_split_jax).
    """
    step = make_scan_step(geom)

    def decode_one(carry, blob):
        xs = unpack_blob_jax(blob, geom, window, km, ke)
        carry, disps = jax.lax.scan(step, carry, xs)
        px = jnp.sum(1 - xs["is_noop"]) * geom.frame_size
        return carry, disps, px

    return _sharded(decode_one, mesh, axis)


def make_sharded_scan_decoder(geom: FrameGeometry, mesh: Mesh,
                              axis: str = "streams"):
    """Dense-dict oracle variant: plans [S, T, ...] stream-major."""
    step = make_scan_step(geom)

    def decode_one(carry, plans):
        carry, disps = jax.lax.scan(step, carry, plans)
        px = jnp.sum(1 - plans["is_noop"]) * geom.frame_size
        return carry, disps, px

    return _sharded(decode_one, mesh, axis)


def stack_stream_plans(per_stream_plans, geom: FrameGeometry, window: int):
    """[stream][(plan, type)] -> stream-major stacked dense plan dict
    [S, T, ...]."""
    from .batch import stack_plans
    stacked = [stack_plans(p, geom, window) for p in per_stream_plans]
    return {k: np.stack([s[k] for s in stacked]) for k in stacked[0]}


def stack_stream_blobs(per_stream_plans, geom: FrameGeometry, window: int,
                       km: int, ke: int) -> np.ndarray:
    """[stream][(plan, type)] -> window-pool blobs [S, total_bytes]."""
    return np.stack([pack_plans_blob(p, geom, window, km, ke)
                     for p in per_stream_plans])


def zero_carry(geom: FrameGeometry, n_streams: int, mesh: Mesh = None,
               axis: str = "streams"):
    carry = []
    for _ in range(3):   # three DISTINCT buffers (the carry is donated)
        z = jnp.zeros((n_streams, geom.total_size), jnp.uint8)
        if mesh is not None:
            z = jax.device_put(z, NamedSharding(mesh, P(axis)))
        carry.append(z)
    return tuple(carry)


# --------------------------------------------------------------------------
# Audio on the mesh
# --------------------------------------------------------------------------

def make_sharded_audio_synth(mesh: Mesh, axis: str = "streams"):
    """Multi-stream MP2 synthesis sharded over the mesh.

    synth(samples [S, T, 2, 32] int32, hist [S, 15, 2, 64] f32)
      -> (u [S, T, 2, 32] f32, hist', total_samples)
    T must be a multiple of 16 (4n whole frames — see
    filterbank.make_synthesize_parallel_jax); normalization stays on host
    (filterbank.finalize_np) for the exact IEEE division.
    """
    from ..ops import filterbank
    synth_one = filterbank.make_synthesize_parallel_jax()

    def synth_shard(samples, hist):
        u, hist = jax.vmap(synth_one)(samples, hist)
        total = jax.lax.psum(u.shape[0] * u.shape[1] * 32, axis)
        return u, hist, total

    def wrapper(samples, hist):
        sharded = jax.shard_map(
            synth_shard, mesh=mesh,
            in_specs=(P(axis), P(axis)),
            out_specs=(P(axis), P(axis), P()))
        return sharded(samples, hist)

    return jax.jit(wrapper, donate_argnums=1)


def zero_audio_hist(n_streams: int, mesh: Mesh = None,
                    axis: str = "streams"):
    h = jnp.zeros((n_streams, 15, 2, 64), jnp.float32)
    if mesh is not None:
        h = jax.device_put(h, NamedSharding(mesh, P(axis)))
    return h
