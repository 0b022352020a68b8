"""Where the persistent compilation cache lives (utils/jaxcache.py):
JAX_COMPILATION_CACHE_DIR when set, else one fixed directory inside the
checkout — never a temporary, per-process or time-based path."""

import os
import subprocess
import sys
import tempfile

import jax
import pytest

from allwave.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing the live
    config of this test process."""
    calls = {}
    monkeypatch.setattr(jaxcache, "_enabled", False)
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_left_to_jax(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jaxcache.enable_compilation_cache()
    assert "jax_compilation_cache_dir" not in updates


def test_default_dir_is_fixed_in_checkout(updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jaxcache.enable_compilation_cache()
    want = os.path.join(REPO, ".jax_cache")
    assert updates["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)
    # idempotent: a second call changes nothing
    updates.clear()
    jaxcache.enable_compilation_cache()
    assert updates == {}


def test_default_dir_is_never_temporary():
    path = jaxcache.DEFAULT_CACHE_DIR
    tmp = os.path.realpath(tempfile.gettempdir())
    assert not os.path.realpath(path).startswith(tmp + os.sep)
    assert str(os.getpid()) not in os.path.basename(path)
    assert os.path.dirname(path) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compiled_entries_land_in_env_dir(tmp_path):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from allwave.utils.jaxcache import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "print(jax.jit(lambda x: jnp.cumsum(x * 3) - 7)(jnp.arange(37)).sum())\n"
    )
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=300
    )
    assert any(p.is_file() for p in tmp_path.rglob("*"))
