"""Where the persistent XLA compile cache goes (`utils/config.py`)."""

import jax
import pytest

from mava_jax.utils import config as config_mod


@pytest.fixture
def recorded(monkeypatch):
    """Record jax.config.update calls made by a fresh enable_..._cache()."""
    calls = {}
    monkeypatch.setattr(config_mod, "_cache_enabled", False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("MAVA_NO_COMPILATION_CACHE", raising=False)
    return calls


def test_env_var_set_leaves_jax_its_directory(recorded, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    config_mod.enable_persistent_compilation_cache()
    assert "jax_compilation_cache_dir" not in recorded  # JAX reads the variable
    assert config_mod._cache_enabled


def test_env_var_unset_uses_fixed_checkout_dir(recorded, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    config_mod.enable_persistent_compilation_cache()
    path = recorded["jax_compilation_cache_dir"]
    root = config_mod.DEFAULT_COMPILATION_CACHE_DIR
    assert path.startswith(str(root))
    # Inside the checkout (next to the package), at a fixed path: the tests
    # force the CPU, so the per-host CPU-fingerprint subdirectory is added.
    assert root.parent == config_mod.CONFIG_DIR.parent.parent
    assert path == str(root / f"cpu-{config_mod._host_cpu_fingerprint()}")
    again = dict(recorded)
    monkeypatch.setattr(config_mod, "_cache_enabled", False)
    config_mod.enable_persistent_compilation_cache()
    assert recorded == again  # same path every time: no pid/time component


def test_checkout_cache_dir_is_git_ignored():
    root = config_mod.DEFAULT_COMPILATION_CACHE_DIR
    gitignore = (root.parent / ".gitignore").read_text().splitlines()
    assert f"{root.name}/" in gitignore


def test_opt_out(recorded, monkeypatch):
    monkeypatch.setenv("MAVA_NO_COMPILATION_CACHE", "1")
    config_mod.enable_persistent_compilation_cache()
    assert recorded == {} and not config_mod._cache_enabled
