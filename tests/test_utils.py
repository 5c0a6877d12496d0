"""Compile-cache path rule, host-clock timing, and the bench's refusal
to measure anything but a GPU."""

import os

import jax
import pytest

from vbcs_tpu.utils import compile_cache as cc
from vbcs_tpu.utils import timing


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, val: calls.append((k, val)))
    return calls


def test_cache_follows_env_when_set(monkeypatch, tmp_path, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert cc.compile_cache_dir("/some/checkout") == str(tmp_path / "c")
    assert cc.enable_compile_cache("/some/checkout") == str(tmp_path / "c")
    assert config_updates == []  # JAX reads the variable itself


def test_cache_defaults_inside_checkout(monkeypatch, tmp_path,
                                        config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(str(tmp_path), ".jax_cache")
    assert cc.compile_cache_dir(str(tmp_path)) == want
    assert cc.enable_compile_cache(str(tmp_path)) == want
    assert config_updates == [("jax_compilation_cache_dir", want)]


def test_cache_dir_is_git_ignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_periter_blocks_on_every_call(monkeypatch):
    seen = []
    monkeypatch.setattr(jax, "block_until_ready", lambda x: seen.append(x))
    calls = iter(range(100))
    t = timing.periter(lambda: next(calls), reps=5, warmup=2)
    assert seen == list(range(7))  # 2 warm-up + 5 timed, all blocked
    assert t >= 0.0


def test_periter_returns_the_median(monkeypatch):
    clock = iter([0.0, 1.0, 10.0, 13.0, 20.0, 22.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(clock))
    assert timing.periter(lambda: None, reps=3, warmup=0) == 2.0


def test_bench_refuses_cpu():
    import bench

    with pytest.raises(SystemExit, match="measures a GPU"):
        bench.main(["--group", "oneshot"])
