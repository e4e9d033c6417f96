"""The choices around the sweep: which implementation runs on a device, how
many rays one call may take, the published peaks the benchmark divides by,
and where the compile cache lives."""
import os

import pytest

import bench
from cbtr_tpu.ops.intersect import ray_chunk_size, sweep_backend
from cbtr_tpu.ops.pallas_sweep import TILE_R
from cbtr_tpu.utils import compile_cache_dir


@pytest.mark.parametrize("platform, expected", [("cpu", "xla"),
                                                ("gpu", "pallas")])
@pytest.mark.parametrize("num_patches", [450, 7200])
def test_sweep_backend_by_platform(platform, expected, num_patches):
    assert sweep_backend(platform, num_patches) == expected


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_sweep_backend_unknown_platform_raises(platform):
    with pytest.raises(ValueError):
        sweep_backend(platform, 450)


def test_chunk_size_whole_batch_fits():
    # 262,144 rays x 450 patches on a 60 GB budget: one call
    assert ray_chunk_size(262_144, 450, "pallas", 60 * 2**30) == 0


def test_chunk_size_without_a_limit_is_unbounded():
    # the CPU reports no bytes_limit
    assert ray_chunk_size(16_777_216, 450, "xla", None) == 0


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_chunk_size_must_chunk(backend):
    R, P, limit = 16_777_216, 7200, 60 * 2**30
    chunk = ray_chunk_size(R, P, backend, limit)
    assert 0 < chunk < R
    assert chunk % TILE_R == 0
    n_chunks = -(-R // chunk)
    # even split: the padded tail is under one alignment unit per chunk
    assert n_chunks * chunk - R < n_chunks * TILE_R
    # one chunk stays within the memory share the bound plans for
    assert ray_chunk_size(chunk, P, backend, limit) == 0


def test_chunk_size_xla_path_chunks_finer():
    R, P, limit = 16_777_216, 450, 60 * 2**30
    assert ray_chunk_size(R, P, "xla", limit) < ray_chunk_size(
        R, P, "pallas", limit)


def test_peaks_h100():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["f32_tflops"] == 67.0
    assert peaks["bf16_tflops"] == 989.0
    assert peaks["hbm_tb_per_s"] == 3.35


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peaks_unknown_device_raises(kind):
    with pytest.raises(ValueError):
        bench.device_peaks(kind)


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_defaults_to_repo(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache_dir() == os.path.join(repo, ".jax_cache")
