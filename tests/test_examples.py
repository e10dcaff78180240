"""Smoke tests: every example must run end-to-end on the default
fixtures.  Each runs in a subprocess pinned to the CPU backend (the
wrapper config-updates to CPU before the example's first jax use, as
conftest does for the suite)."""

import os
import subprocess
import sys

import pytest

_EXAMPLES = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "examples"))
_TESTDATA = os.path.join(os.path.dirname(__file__), "testdata")


from mpeg_tpu import native as _native

# Without the native parser (e.g. Windows CI, no shared-object
# toolchain) each example decodes via the pure-Python parser on a cold
# JAX CPU backend — minutes per example, flaky against the timeout.
pytestmark = pytest.mark.skipif(
    not _native.available(),
    reason="examples are too slow on the pure-Python parser")


@pytest.mark.parametrize("name", [
    "batch_decode.py", "av_serving.py", "play.py",
    "multistream_mesh.py", "clip_serving.py", "pipe_streaming.py",
    "multistream_serving.py",
])
def test_example_runs(name, tmp_path):
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "host_platform_device_count" not in f]
    flags.append("--xla_force_host_platform_device_count=8")
    env["XLA_FLAGS"] = " ".join(flags)

    args = []
    if name == "play.py":
        args = [os.path.join(_TESTDATA, "test.mpg"), str(tmp_path)]
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import runpy, sys\n"
        f"sys.argv = [{name!r}] + {args!r}\n"
        f"runpy.run_path({os.path.join(_EXAMPLES, name)!r}, "
        "run_name='__main__')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=480, env=env, cwd=_EXAMPLES)
    assert r.returncode == 0, f"{name}: {r.stderr[-800:]}"
    assert r.stdout.strip(), f"{name} printed nothing"
