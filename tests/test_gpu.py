"""Checks that only mean something on an NVIDIA GPU.

Every test is marked `gpu` and asks the `gpu_device` fixture whether the
process runs on a GPU; elsewhere (the CPU suite) it skips.  On a card:

    MPEG_TPU_TEST_PLATFORM=gpu python -m pytest -m gpu -p no:xdist tests/

or `python chip_smoke.py`, which runs them in its own process.
"""

import numpy as np
import pytest

from mpeg_tpu.utils import Fnv1a64

pytestmark = pytest.mark.gpu

GOLDEN_VIDEO = 0xEA6D7FCB1340BA3F   # mpeg_test.go:227
GOLDEN_AUDIO_NO_FMA = 0xF1B76CDF8E6CDEA5   # mpeg_test.go:193


@pytest.fixture
def gpu_device():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform: {dev.platform})")
    return dev


def test_audio_golden_is_the_no_fma_hash(gpu_device, mp2_path):
    """The CPU suite accepts any of the reference's three FMA regimes;
    on the GPU both synthesis formulations must give the no-FMA hash
    exactly (XLA:GPU rounds every f32 mul and add on its own)."""
    import mpeg_tpu as mpeg
    from mpeg_tpu.parallel import BatchAudioDecoder

    data = open(mp2_path, "rb").read()
    h = Fnv1a64()
    h.write(np.asarray(BatchAudioDecoder(data, window=32).decode_all())
            .astype("<f4").tobytes())
    assert h.sum64() == GOLDEN_AUDIO_NO_FMA, f"{h.sum64():#018x}"

    buf = mpeg.Buffer(open(mp2_path, "rb"))
    buf.set_load_callback(buf.load_reader_callback)
    audio = mpeg.Audio(buf, backend="jax")   # per-frame scan synthesis
    h = Fnv1a64()
    while (s := audio.decode()) is not None:
        h.write(s.interleaved.astype("<f4").tobytes())
    assert h.sum64() == GOLDEN_AUDIO_NO_FMA, f"{h.sum64():#018x}"


def test_div_out_scale_exact_on_device(gpu_device):
    """The device S16 lane's integer division kernel equals the IEEE
    quotient numpy computes, over random and boundary mantissas."""
    import jax
    import jax.numpy as jnp
    from mpeg_tpu.ops.filterbank import OUT_SCALE, div_out_scale_exact

    rng = np.random.default_rng(5)
    u = rng.standard_normal(1 << 20).astype(np.float32) * \
        np.float32(2.0) ** rng.integers(-60, 40, 1 << 20).astype(np.float32)
    u[:4] = [np.float32(65 << 17), np.float32(-(65 << 17)), 0.0, -1.0]
    got = np.asarray(jax.jit(lambda x: div_out_scale_exact(x, jnp))(u))
    want = u / OUT_SCALE
    normal = np.abs(want) >= np.finfo(np.float32).tiny
    assert np.array_equal(got[normal].view(np.int32),
                          want[normal].view(np.int32))


def test_reconstruct_matches_oracle_at_1080p(gpu_device):
    """Adversarial plans (junk MVs, every MC rounding mode) at the
    fixture geometry and at 1080p: the device reconstruct equals the
    numpy oracle byte for byte."""
    from tests.test_video_kernels import reconstruct_chain_parity
    reconstruct_chain_parity([(160, 120), (1920, 1080)], trials=2)


def test_rgba_matches_oracle(gpu_device):
    """Fused YCbCr->RGBA (Go image/color integers) on the device equals
    the numpy formulation."""
    import jax
    import jax.numpy as jnp
    from mpeg_tpu.ops.color import flat_frame_to_rgba
    from mpeg_tpu.ops.video_recon import FrameGeometry

    geom = FrameGeometry.for_size(1920, 1080)
    flat = np.random.default_rng(9).integers(
        0, 256, geom.total_size).astype(np.uint8)
    got = jax.jit(lambda f: flat_frame_to_rgba(f, geom, jnp))(flat)
    np.testing.assert_array_equal(np.asarray(got),
                                  flat_frame_to_rgba(flat, geom, np))


def test_sharded_decoder_golden_on_every_card(gpu_device, mpeg1video_path):
    """The mesh decoder over every card of this host reproduces the
    video golden on each device."""
    import jax
    from mpeg_tpu.parallel import sharding as sh
    import chip_smoke

    data = open(mpeg1video_path, "rb").read()
    mesh = sh.make_mesh(jax.devices())
    per_dev, geom = chip_smoke.mesh_frame_digests(data, mesh, 16)
    want = chip_smoke.batch_vs_host(data, window=16)
    assert all(d == want for d in per_dev)
    chip_smoke.video_batch_golden(data, 16)
