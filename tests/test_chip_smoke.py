"""CPU checks of the card tooling: chip_smoke.py, the compile-cache
helper and the multi-device dryrun's refusal to fall back to the CPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_smoke(cwd, script):
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run([sys.executable, script], capture_output=True,
                          text=True, timeout=240, env=env, cwd=cwd)


def test_chip_smoke_fails_on_cpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


@pytest.mark.parametrize("phase", [
    "video_batch_golden", "video_interactive_golden", "mpeg_av_parity",
    "audio_f32_golden", "audio_s16_parity",
])
def test_smoke_phase_on_cpu(phase):
    """Each small-fixture phase body reproduces its golden or parity on
    the CPU backend (the same code the card runs)."""
    assert getattr(chip_smoke, phase)()


def test_smoke_multistream_phase_on_cpu():
    """Staggered streams end at different pictures, and the lockstep
    decoder matches the host decoder on each."""
    data = chip_smoke._read("test.mpeg1video")
    streams = chip_smoke.staggered_streams(data, 4)
    assert [len(s) for s in streams] == sorted(
        (len(s) for s in streams), reverse=True)
    assert len(set(len(s) for s in streams)) == 4
    assert "4 streams" in chip_smoke.multistream_vs_host(streams)


def test_reconstruct_floor_bytes_1080p():
    """The memory floor counts the int32 coefficients, the three
    reference frames read and the frame written, plus per-MB metadata."""
    from mpeg_tpu.ops.video_recon import FrameGeometry
    geom = FrameGeometry.for_size(1920, 1080)
    # frames carry edge-extension columns beyond 1920x1088 4:2:0
    assert geom.mb_size == 8160 and geom.total_size >= 1920 * 1088 * 3 // 2
    coeffs = 8160 * 6 * 64 * 4
    meta = 8160 * 6 * 4 * 2 + 8160 * 4 * 3
    assert chip_smoke.reconstruct_floor_bytes(geom) == \
        coeffs + 4 * geom.total_size + meta


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax
    from mpeg_tpu.utils import compile_cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.enable_compile_cache() == str(tmp_path / "c")
    assert calls == [("jax_compilation_cache_dir", str(tmp_path / "c"))]
    assert os.path.isdir(tmp_path / "c")


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    from mpeg_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.compile_cache_dir()
    assert first == compile_cache.compile_cache_dir()
    assert os.path.dirname(first) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert os.path.basename(first) + "/" in f.read().split()


def test_dryrun_refuses_too_few_accelerators(monkeypatch):
    """On an accelerator with fewer devices than asked for, the dryrun
    raises instead of re-running itself on a virtual CPU mesh."""
    import jax
    import __graft_entry__ as g

    class FakeGpu:
        platform = "gpu"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.setattr(g, "_reexec_dryrun_on_virtual_mesh", lambda n: (
        pytest.fail("fell back to a CPU mesh")))
    with pytest.raises(RuntimeError, match="1 gpu device"):
        g.dryrun_multichip(4)
