"""utils/compile_cache.py: where the persistent compilation cache lives."""

import os

import jax

from skele_raytracer_tpu.utils import compile_cache


def _updates(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_var_wins_and_nothing_is_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: the
    helper reports it and sets no cache directory in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _updates(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_default_is_checkout_jax_cache(monkeypatch):
    """Without the variable the cache is <checkout>/.jax_cache — a fixed
    path, so it is found again by the next process."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _updates(monkeypatch)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.enable_compile_cache() == want
    assert calls["jax_compilation_cache_dir"] == want
