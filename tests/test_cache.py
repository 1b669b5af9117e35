"""The persistent compile cache's directory rule."""

import os

import jax

from agatha_jax.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_honours_env_and_sets_no_dir(tmp_path, monkeypatch):
    monkeypatch.setenv(cache.ENV, str(tmp_path / "jc"))
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    assert cache.enable_compilation_cache() == str(tmp_path / "jc")
    assert cache.cache_dir() == str(tmp_path / "jc")
    assert "jax_compilation_cache_dir" not in dict(calls)


def test_cache_default_is_one_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv(cache.ENV, raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".cache", "jax") == cache.cache_dir()
    assert dict(calls)["jax_compilation_cache_dir"] == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".cache/" in f.read().split()
