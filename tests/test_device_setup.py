"""Device-facing setup that runs before any scoring: the compile cache,
the device-memory budget that picks DeviceIndex or StreamedIndex, the
benchmark's peak table, and the refusal to run on too few devices or
without a GPU (bench.py, __graft_entry__.py, chip_smoke.py)."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import jax

import cobs_tpu
from cobs_tpu.query import search as search_mod
from cobs_tpu.query.engine import DeviceIndex, StreamedIndex
from cobs_tpu.settings import (
    DEFAULT_DEVICE_INDEX_BYTES,
    DEVICE_HEADROOM_BYTES,
    configure_compile_cache,
    device_index_budget,
    settings,
)

ROOT = Path(__file__).resolve().parent.parent
DATA = Path(__file__).parent / "data"


@pytest.fixture()
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env(monkeypatch, tmp_path, cache_config):
    jax.config.update("jax_compilation_cache_dir", str(tmp_path / "env"))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert configure_compile_cache() == str(tmp_path / "env")
    # the environment's directory stands: no other path is set in code
    assert jax.config.jax_compilation_cache_dir == str(tmp_path / "env")


def test_compile_cache_defaults_into_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = configure_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_dir_is_git_ignored():
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


class _Device:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("limit", [80 << 30, 16 << 30, 1 << 30])
def test_device_budget_from_memory_limit(monkeypatch, limit):
    monkeypatch.setattr(settings, "max_device_index_bytes", None)
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a: [_Device({"bytes_limit": limit})])
    headroom = max(DEVICE_HEADROOM_BYTES, limit // 8)
    assert device_index_budget() == max(0, limit - headroom)


def test_device_budget_default_without_memory_stats(monkeypatch):
    monkeypatch.setattr(settings, "max_device_index_bytes", None)
    monkeypatch.setattr(jax, "local_devices", lambda *a: [_Device(None)])
    assert (device_index_budget()
            == DEFAULT_DEVICE_INDEX_BYTES)


def test_device_budget_override_is_validated(monkeypatch):
    monkeypatch.setattr(settings, "max_device_index_bytes", 12345)
    assert device_index_budget() == 12345
    monkeypatch.setattr(settings, "max_device_index_bytes", -1)
    with pytest.raises(ValueError):
        device_index_budget()


@pytest.fixture()
def golden_index(tmp_path, request):
    kind = request.param
    docs = tmp_path / "fasta"
    shutil.copytree(DATA / "fasta", docs)
    out = tmp_path / f"g.cobs_{kind}"
    params = (cobs_tpu.ClassicIndexParameters(clobber=True)
              if kind == "classic"
              else cobs_tpu.CompactIndexParameters(clobber=True))
    build = (cobs_tpu.classic_construct if kind == "classic"
             else cobs_tpu.compact_construct)
    old = settings.disable_cache
    settings.disable_cache = True
    try:
        build(cobs_tpu.DocumentList(docs), out, index_params=params)
    finally:
        settings.disable_cache = old
    return out


@pytest.mark.parametrize("golden_index", ["classic", "compact"],
                         indirect=True)
def test_open_index_picks_device_under_budget(golden_index, monkeypatch):
    need = search_mod._device_bytes(str(golden_index))
    monkeypatch.setattr(settings, "max_device_index_bytes", need)
    assert isinstance(search_mod._open_index(str(golden_index), None),
                      DeviceIndex)
    monkeypatch.setattr(settings, "max_device_index_bytes", need - 1)
    assert isinstance(search_mod._open_index(str(golden_index), None),
                      StreamedIndex)


@pytest.mark.parametrize("golden_index", ["classic"], indirect=True)
def test_device_bytes_match_loaded_matrix(golden_index):
    ix = DeviceIndex.from_file(golden_index)
    assert search_mod._device_bytes(str(golden_index)) == ix.matrix.nbytes


def test_bench_peak_h100():
    import bench

    assert bench.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", ""])
def test_bench_peak_unknown_device_raises(kind):
    import bench

    with pytest.raises(ValueError, match="no bandwidth peak"):
        bench.peak_bytes_per_s(kind)


def test_dryrun_multichip_needs_the_devices():
    import __graft_entry__

    with pytest.raises(RuntimeError, match="need"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)


def _run_smoke(cwd, script, env_extra=None):
    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=env)


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(ROOT, ROOT / "chip_smoke.py")
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, tmp_path / "chip_smoke.py",
                   {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_thresholds_fill_top_k():
    import chip_smoke

    t_topk, t_full = chip_smoke.thresholds(chip_smoke.DOCUMENT_SIZE)
    assert 0.0 < t_topk < t_full < 1.0
    assert chip_smoke.reduced(chip_smoke.DOCUMENT_SIZE) == "none"
    assert chip_smoke.reduced(1000).startswith("document_size 1000")
