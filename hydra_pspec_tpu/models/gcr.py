"""Gaussian constrained realization (GCR) of the EoR signal + foreground
amplitudes — the hot path of the Gibbs sampler.

Reference formulation (hydra_pspec/pspec.py:151-374): per time sample,
solve the non-Hermitian block system

    A = [[I + S Ni,  S Ni F ],        b = [ S Ni d + Sh w_a + S Nih w_b ]
         [F^H Ni,    F^H Ni F]]           [ F^H (Ni d + Nih w_b)        ]

with preconditioned CG, where S is the current signal covariance,
Sh = sqrtm(S), Ni the flag-masked inverse noise, Nih = sqrtm(Ni), and F the
foreground mode matrix. A is *constant across the Ntimes right-hand sides*.

Formulation used here: substitute s = Sh u (signal whitening).
Left-multiplying the first block row by Sh^{-1} gives the Hermitian
positive-definite system

    M = [[I + Sh Ni Sh,  Sh Ni F ],      b = [ Sh (Ni d + Nih w_b) + w_a ]
         [F^H Ni Sh,     F^H Ni F]]          [ F^H (Ni d + Nih w_b)      ]

whose solution (u, a) maps to the reference's (s, a) = (Sh u, a) exactly
(same linear system left-multiplied by blockdiag(Sh^{-1}, I)), so samples
are *identically distributed*. M is factored once per Gibbs iteration with
a Cholesky decomposition and solved for all Ntimes right-hand sides as one
multi-RHS triangular solve — replacing the reference's Ntimes CG solves in
forked processes (pspec.py:228,287) with two MXU-friendly batched ops.

Sh itself is analytic: with S = F_op^H diag(ps / n^2) F_op
(pspec.py:313-322,464), Sh = F_op^H diag(sqrt(ps) / n^{3/2}) F_op — no
``scipy.linalg.sqrtm`` (pspec.py:359).
"""
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.fourier import fourier_operator
from ..ops.linalg import NoiseOperators, make_noise_operators, cholesky_solve


class ChainOperators(NamedTuple):
    """Constants of one Gibbs chain (per baseline). All iteration-invariant
    work is hoisted here: the reference rebuilds the Fourier operator and
    masked-noise square roots every iteration (pspec.py:431,434,359-362).

    Shapes: d_w (Ntimes, Nfreqs) complex; w (Nfreqs,) real; fgmodes
    (Nfreqs, Nmodes) complex; fourier_op (Nfreqs, Nfreqs) complex.
    """

    d_w: jax.Array                # flag-masked visibilities (vis * w)
    w: jax.Array                  # per-channel flags, 1 = keep
    fgmodes: jax.Array
    fourier_op: jax.Array
    noise: NoiseOperators
    ni_d: jax.Array               # Ni @ (d_w - Fg a0), FG-deflated — constant
    ni_fg: jax.Array              # Ni @ fgmodes, (Nfreqs, Nmodes) — constant
    maa: jax.Array                # F^H Ni F, (Nmodes, Nmodes) — constant
    a0: jax.Array                 # (Ntimes, Nmodes) GLS FG amplitude shift


def build_chain_operators(vis, w, fgmodes, ninv, dtype=None) -> ChainOperators:
    """Precompute chain constants from raw inputs.

    ``ninv`` may be a scalar, (Nfreqs,) diagonal, or (Nfreqs, Nfreqs) dense
    inverse-noise matrix (reference accepts dense Ninv, pspec.py:338-340).
    """
    vis = jnp.asarray(vis)
    if dtype is None:
        dtype = vis.dtype
    rdtype = jnp.finfo(dtype).dtype
    nfreqs = vis.shape[-1]
    w = jnp.asarray(w).astype(rdtype)
    fg = jnp.asarray(fgmodes).astype(dtype)
    noise = make_noise_operators(w, jnp.asarray(ninv))
    noise = NoiseOperators(
        noise.ni_diag.astype(rdtype),
        noise.nih_diag.astype(rdtype),
        noise.ninv_full_diag.astype(rdtype),
        None if noise.ni_dense is None else noise.ni_dense.astype(dtype),
        None if noise.nih_dense is None else noise.nih_dense.astype(dtype),
    )
    d_w = (vis * w).astype(dtype)
    ni_fg = (
        noise.ni_diag[:, None] * fg
        if noise.is_diagonal
        else noise.ni_dense @ fg
    )
    maa = fg.conj().T @ ni_fg
    # FG deflation (exact reparameterization): solve for amplitudes
    # relative to the GLS foreground fit a0 so the solution vector's
    # components are comparable in magnitude — in reduced precision the
    # norm-wise solve error otherwise lands on the small EoR components.
    rhs0 = fg.conj().T @ noise.apply_ni(d_w).T
    a0 = jnp.linalg.lstsq(maa, rhs0)[0].T
    ni_d = noise.apply_ni(d_w - a0 @ fg.T)
    fop = fourier_operator(nfreqs, dtype=dtype)
    return ChainOperators(d_w, w, fg, fop, noise, ni_d, ni_fg, maa, a0)


def signal_sqrt_operator(ops: ChainOperators, ps: jax.Array) -> jax.Array:
    """Dense Sh = F_op^H diag(sqrt(ps) / n^{3/2}) F_op (Hermitian PSD).

    One (n x n) matmul with a diagonal scale — the MXU replacement for the
    reference's per-iteration Schur-decomposition ``sqrtm`` (pspec.py:359).
    """
    n = ps.shape[-1]
    sh_delay = jnp.sqrt(jnp.clip(ps, 0.0, None)) / (n * jnp.sqrt(jnp.asarray(n, ps.dtype)))
    f = ops.fourier_op
    return (f.conj().T * sh_delay.astype(f.dtype)) @ f


class GCRResult(NamedTuple):
    signal_cr: jax.Array   # (Ntimes, Nfreqs) complex — in-painted signal CRs
    fg_amps: jax.Array     # (Ntimes, Nmodes) complex — FG amplitude draws


def gcr_solve(
    ops: ChainOperators,
    ps: jax.Array,
    omega_a: Optional[jax.Array],
    omega_b: Optional[jax.Array],
    jitter: float = 0.0,
) -> GCRResult:
    """Draw constrained realizations for all time samples at once.

    ``omega_a``/``omega_b`` are (Ntimes, Nfreqs) standard complex normal
    fluctuation vectors; pass ``None`` for both to get the MAP estimate
    (reference pspec.py:210-213).
    """
    ntimes, nfreqs = ops.d_w.shape
    nmodes = ops.fgmodes.shape[-1]
    dtype = ops.d_w.dtype

    sh = signal_sqrt_operator(ops, ps)
    ni_sh = (
        ops.noise.ni_diag[:, None] * sh
        if ops.noise.is_diagonal
        else ops.noise.ni_dense @ sh
    )
    muu = jnp.eye(nfreqs, dtype=dtype) + sh @ ni_sh
    mua = sh @ ops.ni_fg
    m = jnp.block([[muu, mua], [mua.conj().T, ops.maa]])

    # Right-hand sides for all times, laid out (Nparams, Ntimes).
    rc = ops.ni_d  # Ni d term (constant)
    if omega_b is not None:
        rc = rc + ops.noise.apply_nih(omega_b)
    b_top = sh @ rc.T
    if omega_a is not None:
        b_top = b_top + omega_a.T
    b_bot = ops.fgmodes.conj().T @ rc.T
    b = jnp.concatenate([b_top, b_bot], axis=0)

    # Jacobi (diagonal) rescaling: the bandpowers span many orders of
    # magnitude, so equilibrate before the Cholesky factorization. Exact in
    # exact arithmetic; essential at complex64.
    d = jnp.sqrt(jnp.clip(jnp.diagonal(m).real, jnp.finfo(ps.dtype).tiny, None))
    dinv = (1.0 / d).astype(dtype)
    m_scaled = m * (dinv[:, None] * dinv[None, :])
    x = cholesky_solve(m_scaled, dinv[:, None] * b, jitter=jitter)
    x = dinv[:, None] * x

    u = x[:nfreqs]
    amps = x[nfreqs:]
    signal = (sh @ u).T
    return GCRResult(signal_cr=signal, fg_amps=amps.T + ops.a0)
