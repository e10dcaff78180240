"""Test configuration.

Tests run on CPU with a virtual 8-device mesh so sharding paths are
exercised without accelerator hardware.  Set MPEG_TPU_TEST_PLATFORM=gpu
to run the suite against a real card instead; the `gpu`-marked tests
(tests/test_gpu.py) run only there.
"""

import os
import pathlib

import pytest

if os.environ.get("MPEG_TPU_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = \
            (flags + " --xla_force_host_platform_device_count=8").strip()

    # XLA:CPU contracts f32 mul+add to FMA on x86, breaking the no-FMA
    # golden audio hashes; cap the codegen ISA so the CPU stays exact.
    from mpeg_tpu.utils.bitexact import enable_cpu_bitexact
    enable_cpu_bitexact()

    # Pin the CPU before any backend is initialized, whatever platform
    # the environment asks for.
    import jax
    jax.config.update("jax_platforms", "cpu")

TESTDATA = pathlib.Path(__file__).parent / "testdata"


@pytest.fixture(scope="session")
def mp2_path():
    return TESTDATA / "test.mp2"


@pytest.fixture(scope="session")
def mpeg1video_path():
    return TESTDATA / "test.mpeg1video"


@pytest.fixture(scope="session")
def mpg_path():
    return TESTDATA / "test.mpg"
