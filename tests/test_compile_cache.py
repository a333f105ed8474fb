"""The persistent compile cache's directory rule."""
import os

import jax

from slam_eds_tpu import compile_cache as cc


def test_env_var_is_the_only_directory(monkeypatch, tmp_path):
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cc.cache_dir("/somewhere") == str(tmp_path)
    assert cc.setup_cache("/somewhere") == str(tmp_path)
    # JAX reads the variable itself; setup_cache sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_fixed_path_when_env_var_unset(monkeypatch, tmp_path):
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = cc.setup_cache(str(tmp_path))
        assert path == cc.setup_cache(str(tmp_path))        # stable
        assert os.path.dirname(path) == os.path.join(str(tmp_path),
                                                     ".jax_cache")
        assert os.path.basename(path).startswith(cc.machine_fingerprint())
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_fingerprint_is_stable_hex():
    fp = cc.machine_fingerprint()
    assert fp == cc.machine_fingerprint()
    assert len(fp) == 12 and int(fp, 16) >= 0
