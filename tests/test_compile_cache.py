"""The persistent compile cache helper shared by every entry point."""

import os

import jax
import pytest

from enlsip_tpu.utils import cache


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_env_unset_uses_fixed_repo_path(monkeypatch, restore_cache_config):
    monkeypatch.delenv(cache.ENV, raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(cache.REPO, ".jax_cache")
    assert os.path.isdir(os.path.join(cache.REPO, "enlsip_tpu"))
    assert jax.config.jax_compilation_cache_dir == path


def test_env_set_is_honoured_untouched(monkeypatch, tmp_path,
                                       restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv(cache.ENV, str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code.
    assert jax.config.jax_compilation_cache_dir is None
