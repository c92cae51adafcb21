"""Masked-noise operators and Hermitian solve helpers for the GCR system.

The reference manipulates four dense operators per Gibbs iteration
(``Sh = sqrtm(S)``, ``Ni = w * Ninv * w``, ``Nih = sqrtm(Ni)``, and
``pinv(A)``; hydra_pspec/pspec.py:325-374). Here:

  * ``Ni`` masking is elementwise (``(w w^T) ∘ Ninv``) and, for the diagonal
    noise models used by every shipped configuration
    (run-hydra-pspec.py:436-438 builds ``Ninv`` from a diagonal noise
    covariance or ``I / sigma^2``), reduces to a vector.
  * ``Nih`` is ``sqrt`` of that vector (diagonal path) or a one-time
    Hermitian ``eigh`` square root (dense path) — computed once per chain,
    not once per iteration, since flags and the noise model are constants of
    the chain.
  * The signal square root never appears as a ``sqrtm``: it is the analytic
    delay-space transform handled in models/gcr.py.
"""
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class NoiseOperators(NamedTuple):
    """Per-chain constants derived from (flags, Ninv).

    ``ni_diag``/``nih_diag`` are the masked inverse-noise and its sqrt for
    the diagonal path; ``ni_dense``/``nih_dense`` are their dense Hermitian
    counterparts (``None`` on the diagonal path). ``ninv_full_diag`` is the
    *unmasked* diagonal of Ninv used by the chi^2 diagnostic
    (pspec.py:452)."""

    ni_diag: jax.Array
    nih_diag: jax.Array
    ninv_full_diag: jax.Array
    ni_dense: Optional[jax.Array] = None
    nih_dense: Optional[jax.Array] = None

    @property
    def is_diagonal(self) -> bool:
        return self.ni_dense is None

    def apply_ni(self, x: jax.Array) -> jax.Array:
        """``Ni @ x`` for x of shape (..., Nfreqs) (rows are vectors)."""
        if self.is_diagonal:
            return x * self.ni_diag
        return x @ self.ni_dense.T

    def apply_nih(self, x: jax.Array) -> jax.Array:
        """``Nih @ x`` for x of shape (..., Nfreqs)."""
        if self.is_diagonal:
            return x * self.nih_diag
        return x @ self.nih_dense.T


def hermitian_sqrt(m: jax.Array) -> jax.Array:
    """PSD square root of a Hermitian matrix via eigendecomposition.
    Equals ``scipy.linalg.sqrtm`` for Hermitian PSD input (the reference
    calls sqrtm on the masked noise at pspec.py:362)."""
    vals, vecs = jnp.linalg.eigh(m)
    vals = jnp.clip(vals, 0.0, None)
    return (vecs * jnp.sqrt(vals)) @ vecs.conj().T


def make_noise_operators(w: jax.Array, ninv) -> NoiseOperators:
    """Build per-chain noise operators from flags ``w`` (1 = keep) and the
    inverse noise variance ``ninv`` — a (Nfreqs,) vector, a (Nfreqs, Nfreqs)
    matrix, or a scalar."""
    ninv = jnp.asarray(ninv)
    w = jnp.asarray(w)
    wr = w.astype(jnp.result_type(ninv.real.dtype, w.dtype))
    if ninv.ndim <= 1:
        diag_full = jnp.broadcast_to(ninv.real, w.shape)
        ni = wr * diag_full * wr
        return NoiseOperators(ni, jnp.sqrt(ni), diag_full)
    diag_full = jnp.diagonal(ninv).real
    # Fast path: exactly diagonal matrices (every shipped config).
    offdiag = ninv - jnp.diag(jnp.diagonal(ninv))
    # NOTE: this is a trace-time Python branch only when ninv is a concrete
    # (host) array; inside jit callers should pass the vector form directly.
    if isinstance(offdiag, jax.core.Tracer) or jnp.any(jnp.abs(offdiag) > 0):
        ni = (wr[:, None] * ninv) * wr[None, :]
        nih = hermitian_sqrt(ni)
        ni_vec = jnp.diagonal(ni).real
        return NoiseOperators(ni_vec, jnp.sqrt(ni_vec), diag_full, ni, nih)
    ni = wr * diag_full * wr
    return NoiseOperators(ni, jnp.sqrt(ni), diag_full)


def cholesky_solve(m: jax.Array, b: jax.Array, jitter: float = 0.0):
    """Solve the Hermitian positive-definite system ``m x = b`` by Cholesky.

    ``m``: (..., n, n) Hermitian PD; ``b``: (..., n, k). Returns (..., n, k).
    ``jitter`` adds ``jitter * mean(diag)`` to the diagonal — used on the
    f32 path to absorb roundoff in near-semidefinite foreground blocks.
    """
    n = m.shape[-1]
    if jitter:
        scale = jnp.mean(jnp.diagonal(m, axis1=-2, axis2=-1).real, axis=-1)
        m = m + (jitter * scale)[..., None, None] * jnp.eye(n, dtype=m.dtype)
    chol = jnp.linalg.cholesky(m)
    y = jax.scipy.linalg.solve_triangular(chol, b, lower=True)
    return jax.scipy.linalg.solve_triangular(
        chol.conj().swapaxes(-1, -2), y, lower=False
    )
