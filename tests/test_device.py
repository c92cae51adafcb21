"""Backend decisions (hydra_pspec_tpu/device.py): engine, precision and
solver selection on each backend, rejection of removed names, and where
the persistent compilation cache goes."""
import types

import jax
import pytest

from hydra_pspec_tpu import device
from hydra_pspec_tpu.utils.config import RunConfig


@pytest.fixture
def on_gpu(monkeypatch):
    """Pretend JAX's default backend is a GPU, with x64 off."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        jax, "config", types.SimpleNamespace(jax_enable_x64=False))


def test_gpu_selects_real_engine_x32_and_chol(on_gpu):
    assert device.select_engine("auto") == "real"
    assert device.select_precision("auto") == "x32"
    assert device.select_solver("auto") == "chol"


def test_cpu_selects_x64_and_complex_engine():
    assert jax.default_backend() == "cpu"
    assert device.select_precision("auto") == "x64"
    assert device.select_engine("auto") == (
        "complex" if jax.config.jax_enable_x64 else "real")
    assert device.select_solver("auto") == "chol"


@pytest.mark.parametrize("kind, value", [
    ("engine", "real"), ("engine", "complex"), ("precision", "x32"),
    ("precision", "x64"), ("solver", "chol"), ("solver", "recinv"),
])
def test_explicit_choice_passes_through(on_gpu, kind, value):
    assert getattr(device, f"select_{kind}")(value) == value


@pytest.mark.parametrize("kind, value", [
    ("engine", "mega"), ("solver", "pallas"),
    ("solver", "pallas2"), ("solver", "pallas2f"), ("precision", "bf16"),
])
def test_removed_or_unknown_name_raises(kind, value):
    with pytest.raises(ValueError, match=value):
        getattr(device, f"select_{kind}")(value)
    with pytest.raises(ValueError, match=value):
        RunConfig(**{kind: value})


@pytest.mark.parametrize("key", ["warm_ns", "drift_max"])
def test_removed_config_key_raises(tmp_path, key):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"Niter: 5\n{key}: 1\n")
    with pytest.raises(ValueError, match="removed"):
        RunConfig.from_yaml(cfg)


def test_compile_cache_follows_environment(monkeypatch, tmp_path):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.setup_compile_cache() == str(tmp_path)
    assert calls == []                     # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.setup_compile_cache()
    assert path == str(device.CHECKOUT / ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
    ignored = (device.CHECKOUT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
