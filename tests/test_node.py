"""Start-up: where the persistent compilation cache lives."""

import os

import jax
import pytest

from starneig_jax import node

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [True, False])
def test_compilation_cache_dir(env, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins and no other directory is set in code;
    without it the cache is <checkout>/.jax_cache, whatever the cwd."""
    updates = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: updates.__setitem__(name, val))
    monkeypatch.chdir(tmp_path)
    if env:
        mine = str(tmp_path / "cc")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", mine)
        assert node.compilation_cache_dir() == mine
        assert node.enable_compilation_cache() == mine
        assert "jax_compilation_cache_dir" not in updates
        assert not os.path.exists(mine)  # left to jax to create
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(CHECKOUT, ".jax_cache")
        assert node.compilation_cache_dir() == want
        assert node.enable_compilation_cache() == want
        assert updates["jax_compilation_cache_dir"] == want
        assert not os.path.exists(tmp_path / ".jax_cache")
