"""What the backend decides: the one module that reads ``jax.default_backend()``.

* engine: the complex parity engine under x64, else the float32 real-pair
  engine (models/rgibbs.py);
* precision: x64 on the CPU (parity with the float64 reference), x32 on an
  accelerator;
* solver: the XLA Hermitian solve of the real engine (ops/cplx.py);
* the persistent compilation cache's directory.
"""
import os
from pathlib import Path

import jax

ENGINES = ("auto", "real", "complex")
SOLVERS = ("auto", "chol", "recinv")
PRECISIONS = ("auto", "x32", "x64")

CHECKOUT = Path(__file__).resolve().parents[1]


def _check(kind, value, allowed):
    if value in allowed:
        return value
    raise ValueError(
        f"{kind} {value!r} is not supported; expected one of {allowed}")


def check_engine(engine: str) -> str:
    return _check("engine", engine, ENGINES)


def check_solver(solver: str) -> str:
    return _check("solver", solver, SOLVERS)


def check_precision(precision: str) -> str:
    return _check("precision", precision, PRECISIONS)


def select_engine(engine: str = "auto") -> str:
    """``auto``: the complex parity engine under x64, else the real-pair
    float32 engine."""
    if check_engine(engine) != "auto":
        return engine
    return "complex" if jax.config.jax_enable_x64 else "real"


def select_precision(precision: str = "auto") -> str:
    """``auto``: x64 on the CPU, x32 on an accelerator."""
    if check_precision(precision) != "auto":
        return precision
    return "x64" if jax.default_backend() == "cpu" else "x32"


def select_solver(solver: str = "auto") -> str:
    """``auto``: Cholesky of the real embedding. Timed against the
    recursive-inverse solve on an H100 at 100 baselines x 203 x 120
    (CHANGES.md), Cholesky was the faster of the two."""
    if check_solver(solver) != "auto":
        return solver
    return "chol"


def setup_compile_cache() -> str:
    """Persistent compilation cache: ``JAX_COMPILATION_CACHE_DIR`` when set
    (JAX reads it itself, so nothing else is set), else ``.jax_cache`` in
    the checkout. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
