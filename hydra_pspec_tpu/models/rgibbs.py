"""Real-pair execution engine for the Gibbs sampler — batch-first, float32.

Same math as models/gcr.py + models/gibbs.py (the whitened Hermitian GCR
system, analytic signal square roots, inverse-gamma bandpower draws), with
three design decisions:

  * every complex quantity is a ``C(re, im)`` pair of real arrays
    (ops/cplx.py), so the whole step runs in float32 with every product at
    ``cplx.PRECISION``;
  * the (baseline x chain) batch is an *explicit leading axis* on every
    array rather than a vmap transform, so the Hermitian solve is one
    batched factorisation for the whole batch;
  * the constant foreground block is eliminated by an exact Schur
    reduction before the solve, shrinking it from Nfreqs+Nmodes to Nfreqs
    (embedded real size 240 for the reference shapes).

The complex engine (models/gibbs.py) remains the readable spec and the
CPU/x64 parity path; exact agreement between the two at float64 is pinned
by tests/test_rgibbs.py.

Reference semantics implemented: hydra_pspec/pspec.py:151-490.
"""
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import device
from ..ops import cplx
from ..ops.cplx import C
from ..ops.invgamma import (InvGammaTable, make_invgamma_table,
                            sample_bandpowers_from_beta)


class RChainOperators(NamedTuple):
    """Per-chain constants, real-pair form, with a leading batch axis B
    (build one per baseline/chain with :func:`build_chain_operators`, then
    :func:`stack_chain_operators`). Built host-side (numpy float64) once —
    only the per-iteration step runs on the device.

    ``f`` (the centered DFT operator) and ``igt`` (the inverse-gamma CDF
    table) are shared across the batch and stay unbatched."""

    d_w: C            # (B, Ntimes, Nfreqs) masked visibilities
    w: jax.Array      # (B, Nfreqs) flags
    f: C              # (Nfreqs, Nfreqs) centered DFT operator — shared
    ni_diag: jax.Array       # (B, Nfreqs)
    nih_diag: jax.Array      # (B, Nfreqs)
    ninv_full_diag: jax.Array  # (B, Nfreqs)
    fg: C             # (B, Nfreqs, Nmodes)
    ni_d: C           # (B, Ntimes, Nfreqs) — Ni (d - Fg a0), FG-deflated
    a0: C             # (B, Ntimes, Nmodes) host GLS foreground amplitudes
    p_tilde: C        # (B, Nfreqs, Nfreqs) — F (Ni - G (Ni Fg)^H) F^H / n
    g_mat: C          # (B, Nfreqs, Nmodes) — G = Ni Fg Maa^{-1}
    maa_inv: C        # (B, Nmodes, Nmodes)
    igt: InvGammaTable  # shared (same Ntimes for all chains)
    ni_dense: Optional[C] = None   # (B, Nfreqs, Nfreqs) masked Ni — dense
    nih_dense: Optional[C] = None  # (B, Nfreqs, Nfreqs) sqrtm(Ni) — dense
    # noise path only (None for the diagonal models every shipped config
    # uses; the delay-basis Schur reduction itself is generic in Ni)


def build_chain_operators(vis, w, fgmodes, ninv, dtype=jnp.float32) -> RChainOperators:
    """Build a batch-of-one chain. ``ninv``: scalar, (Nfreqs,) diagonal, or
    an (Nfreqs, Nfreqs) matrix — genuinely dense Hermitian noise takes the
    dense path (reference accepts dense Ninv in its hot path,
    hydra_pspec/pspec.py:336-361)."""
    vis = np.asarray(vis, dtype=np.complex128)
    nfreqs = vis.shape[-1]
    w = np.asarray(w, dtype=np.float64)
    ninv = np.asarray(ninv)
    ni_mat = nih_mat = None
    if ninv.ndim == 2 and np.abs(ninv - np.diag(np.diag(ninv))).max() > 0:
        ninv_full = np.diagonal(ninv).real.astype(np.float64)
        ni_mat = (w[:, None] * np.asarray(ninv, dtype=np.complex128)
                  ) * w[None, :]
        # one-time Hermitian PSD square root (chain constant — the
        # reference recomputes sqrtm every iteration, pspec.py:362)
        vals, vecs = np.linalg.eigh(ni_mat)
        nih_mat = (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.conj().T
        ni = np.diagonal(ni_mat).real
        nih = np.sqrt(ni)  # diagonal kept for provenance; dense path used
    else:
        if ninv.ndim == 2:
            ninv = np.diag(ninv).real
        ninv_full = np.broadcast_to(np.real(ninv), (nfreqs,)).astype(np.float64)
        ni = w * ninv_full * w
        nih = np.sqrt(ni)
    fg = np.asarray(fgmodes, dtype=np.complex128)
    d_w = vis * w

    def apply_ni_rows(x):
        """Ni @ x^T as rows: x (..., Nfreqs)."""
        if ni_mat is None:
            return ni * x
        return x @ ni_mat.T

    ni_fg = ni[:, None] * fg if ni_mat is None else ni_mat @ fg
    maa = fg.conj().T @ ni_fg
    # FG deflation (exact): solve for amplitudes relative to the host-side
    # float64 GLS foreground fit a0 — otherwise the f32 solve's norm-wise
    # error (~cond * eps * |x|) lands on the small EoR components.
    rhs0 = fg.conj().T @ apply_ni_rows(d_w).T
    a0 = np.linalg.lstsq(maa, rhs0, rcond=None)[0].T
    d_defl = d_w - a0 @ fg.T
    ni_d = apply_ni_rows(d_defl)
    # FG block Schur reduction constants (see gcr_solve docstring), with
    # the reduced noise operator pre-rotated to the delay basis where the
    # signal square root is diagonal: P_tilde = F P F^H / n. Generic in Ni.
    maa_inv = np.linalg.pinv(maa)
    g_mat = ni_fg @ maa_inv
    p_base = np.diag(ni).astype(complex) if ni_mat is None else ni_mat
    p_mat = p_base - g_mat @ ni_fg.conj().T
    i_idx = np.arange(nfreqs) - nfreqs // 2
    f_op = np.exp(-2j * np.pi * np.outer(i_idx, i_idx) / nfreqs)
    p_tilde = f_op @ p_mat @ f_op.conj().T / nfreqs

    cv = lambda z: cplx.from_numpy(np.asarray(z)[None], dtype=dtype)
    rv = lambda x: jnp.asarray(np.asarray(x)[None], dtype=dtype)
    return RChainOperators(
        d_w=cv(d_w),
        w=rv(w),
        f=cplx.dft_matrix(nfreqs, dtype=dtype),
        ni_diag=rv(ni),
        nih_diag=rv(nih),
        ninv_full_diag=rv(ninv_full),
        fg=cv(fg),
        ni_d=cv(ni_d),
        a0=cv(a0),
        p_tilde=cv(p_tilde),
        g_mat=cv(g_mat),
        maa_inv=cv(maa_inv),
        igt=make_invgamma_table(vis.shape[0], dtype=dtype),
        ni_dense=None if ni_mat is None else cv(ni_mat),
        nih_dense=None if nih_mat is None else cv(nih_mat),
    )


def stack_chain_operators(ops_list) -> RChainOperators:
    """Concatenate batches of chains along the batch axis (shared fields
    taken from the first element)."""
    stacked = jax.tree.map(
        lambda *xs: jnp.concatenate(xs, axis=0),
        *[o._replace(f=None, igt=None) for o in ops_list],
    )
    return stacked._replace(f=ops_list[0].f, igt=ops_list[0].igt)


def broadcast_chain_operators(ops: RChainOperators, batch: int) -> RChainOperators:
    """Tile a batch-of-one chain to ``batch`` identical chains (the
    replicated-baseline scaling fixture, set_up_scaling_data.py:19-34)."""

    def bc(x):
        return jnp.broadcast_to(x, (batch,) + x.shape[1:])

    out = jax.tree.map(bc, ops._replace(f=None, igt=None))
    return out._replace(f=ops.f, igt=ops.igt)


class RGibbsSample(NamedTuple):
    signal_cr: C      # (B, Ntimes, Nfreqs)
    ps: jax.Array     # (B, Nfreqs)
    fg_amps: C        # (B, Ntimes, Nmodes)
    chisq: jax.Array  # (B, Ntimes, Nfreqs) (or (B,) mean when lean)
    ln_post: jax.Array  # (B,)


def _t(x: C) -> C:
    return C(jnp.swapaxes(x.re, -1, -2), jnp.swapaxes(x.im, -1, -2))


def gcr_solve(
    ops: RChainOperators,
    ps: jax.Array,
    omega_a_delay: Optional[C],
    omega_b: Optional[C],
    jitter: float = 0.0,
    solver: str = "auto",
):
    """Constrained-realization draw for all (chain, time) pairs at once,
    formulated in the delay basis where the signal square root is diagonal.

    ``ps``: (B, Nfreqs). ``omega_b``: (B, Ntimes, Nfreqs) standard complex
    normal (frequency basis). ``omega_a_delay``: (B, Ntimes, Nfreqs)
    complex normal with covariance ``n I`` — i.e. ``F @ omega_a`` for a
    standard draw ``omega_a``, which production code samples *directly* as
    ``sqrt(n) x standard normal`` (exact in distribution, no transform).
    Pass None for both for the MAP estimate.

    Derivation: the whitened FG-reduced system ``(I + Sh P Sh) u = b``
    (Sh = F^H diag(sd) F, P constant) conjugated by the centered DFT gives

        (I + D P_tilde D) u~ = D (F rc_red) + omega_a_delay^T,
        D = diag(sqrt(ps / n)),   P_tilde = F P F^H / n  (chain constant),

    so the per-iteration system *build* is one elementwise outer-scaling
    (no matmuls), the solve is Nfreqs x Nfreqs, and the delay transform of
    the signal — the bandpower sufficient statistic — is ``D u~``, free.

    Returns ``(signal_cr, fg_amps, sk)`` with ``sk`` the centered delay
    transform of the signal, shape (B, Ntimes, Nfreqs).
    """
    nfreqs = ops.d_w.shape[-1]
    dd = jnp.sqrt(jnp.clip(ps, 0.0, None) / nfreqs)  # (B, n)
    outer = dd[:, :, None] * dd[:, None, :]
    s_u = C(
        outer * ops.p_tilde.re + jnp.eye(nfreqs, dtype=dd.dtype),
        outer * ops.p_tilde.im,
    )

    rc = ops.ni_d
    if omega_b is not None:
        if ops.nih_dense is not None:
            # rows: (Nih w_b)^T = w_b @ Nih^T = w_b @ conj(Nih) (Hermitian)
            rc = rc + cplx.matmul(omega_b, ops.nih_dense.conj())
        else:
            rc = rc + C(
                ops.nih_diag[:, None, :] * omega_b.re,
                ops.nih_diag[:, None, :] * omega_b.im,
            )
    rc_t = _t(rc)                                    # (B, Nfreqs, Ntimes)
    b_a = cplx.matmul(ops.fg.adjoint(), rc_t)        # (B, Nmodes, Ntimes)
    rc_red = rc_t - cplx.matmul(ops.g_mat, b_a)
    frc = cplx.matmul(ops.f, rc_red)                 # F @ rc_red
    b_u = C(dd[:, :, None] * frc.re, dd[:, :, None] * frc.im)
    if omega_a_delay is not None:
        oat = _t(omega_a_delay)
        b_u = b_u + oat

    u = _solve(s_u, b_u, jitter, solver)
    sk_t = C(dd[:, :, None] * u.re, dd[:, :, None] * u.im)  # F s, delay basis
    # back to frequency basis: s = F^H sk / n
    finv = C(ops.f.re.T / nfreqs, -ops.f.im.T / nfreqs)
    sig_t = cplx.matmul(finv, sk_t)                  # (B, Nfreqs, Ntimes)
    signal_cr = _t(sig_t)

    amps_t = cplx.matmul(ops.maa_inv, b_a) - cplx.matmul(
        ops.g_mat.adjoint(), sig_t
    )
    fg_amps = _t(amps_t) + ops.a0                    # undo FG deflation
    return signal_cr, fg_amps, _t(sk_t)


def _solve(m: C, b: C, jitter: float, solver: str) -> C:
    if device.select_solver(solver) == "recinv":
        return cplx.hermitian_solve_recinv(m, b, jitter=jitter)
    return cplx.hermitian_solve(m, b, jitter=jitter)


def gibbs_step(
    key: jax.Array,
    ps: jax.Array,
    ops: RChainOperators,
    ps_prior: jax.Array,
    map_estimate: bool = False,
    jitter: float = 0.0,
    prior_idx=None,
    solver: str = "auto",
    all_unflagged: bool = False,
    sids=None,
):
    """One Gibbs alternation for the whole batch (reference
    pspec.py:377-490 semantics per chain). ``all_unflagged`` (static,
    host-derived): when every chain has w == 1 the masked delay transform
    used by ln_post equals ``sk`` exactly — skip recomputing it."""
    batch, ntimes, nfreqs = ops.d_w.shape
    # Per-chain keyed draws (fold_in by global stream id, defaulting to the
    # batch index): each chain's stream depends only on (key, its id), NOT
    # on the total batch shape or its slot position — so mesh padding and
    # multi-process slot placement leave every real chain's samples
    # bit-identical to an unpadded/single-process run.
    if sids is None:
        sids = jnp.arange(batch)
    kb = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(key, i), 3))(
        sids
    )                                             # (B, 3) keys
    k_oma, k_omb, k_ps = kb[:, 0], kb[:, 1], kb[:, 2]

    if map_estimate:
        omega_a = omega_b = None
    else:
        def draw(keys):
            return jax.vmap(
                lambda k: cplx.standard_normal(
                    k, (ntimes, nfreqs), dtype=ops.d_w.dtype
                )
            )(keys)

        # omega_a is drawn directly in the delay basis with covariance n*I
        # (= F @ standard normal in distribution) — saves a transform.
        scale = np.sqrt(nfreqs).astype(np.float32)
        oa = draw(k_oma)
        omega_a = C(oa.re * scale, oa.im * scale)
        omega_b = draw(k_omb)
    signal_cr, fg_amps, sk = gcr_solve(
        ops, ps, omega_a, omega_b, jitter=jitter, solver=solver
    )

    # model = signal + amps @ fg^T ; chisq vs unmasked noise diagonal
    model = signal_cr + cplx.matmul(fg_amps, _t(ops.fg))
    resid = ops.d_w - model
    chisq = resid.abs2() * ops.ninv_full_diag[:, None, :]

    # Bandpower draw from beta_k = sum_t |sk_t|^2 per chain (sk falls out
    # of the delay-basis solve for free)
    beta = jnp.sum(sk.abs2(), axis=1)                # (B, Nfreqs)
    # vmapped over per-chain keys for the same batch-composition
    # invariance as the omega draws above (the table is chain-shared:
    # alpha = Ntimes - 1 is a run constant).
    ps_new = jax.vmap(
        lambda k, b: sample_bandpowers_from_beta(
            k, b, ntimes, ps_prior, prior_idx, ops.igt
        )
    )(k_ps, beta)

    # ln posterior under the new sample (multiplicative masking form)
    if ops.ni_dense is not None:
        ni_r = cplx.matmul(resid, ops.ni_dense.conj())
        noise_term = jnp.sum(
            ni_r.re * resid.re + ni_r.im * resid.im, axis=(1, 2)
        )
    else:
        noise_term = jnp.sum(
            ops.ni_diag[:, None, :] * resid.abs2(), axis=(1, 2)
        )
    if all_unflagged:
        skm = sk
    else:
        skm = cplx.cfft_rows(
            C(signal_cr.re * ops.w[:, None, :],
              signal_cr.im * ops.w[:, None, :]),
            ops.f,
        )
    sig_term = jnp.sum(
        skm.abs2()
        / jnp.maximum(ps_new, jnp.finfo(ps_new.dtype).tiny)[:, None, :],
        axis=(1, 2),
    )
    ln_post = -(noise_term + sig_term)

    return ps_new, RGibbsSample(signal_cr, ps_new, fg_amps, chisq, ln_post)


def run_chain(
    key, ops: RChainOperators, ps0, ps_prior, niter: int,
    map_estimate: bool = False, jitter: float = 0.0, store_cr: bool = True,
    prior_idx=None, solver: str = "auto", all_unflagged: bool = False,
    sids=None,
):
    """``lax.scan`` over iterations for the whole batch."""

    def body(ps, i):
        ps_new, s = gibbs_step(
            jax.random.fold_in(key, i), ps, ops, ps_prior,
            map_estimate=map_estimate, jitter=jitter, prior_idx=prior_idx,
            solver=solver, all_unflagged=all_unflagged, sids=sids,
        )
        if not store_cr:
            zero = jnp.zeros((), dtype=ps_new.dtype)
            s = RGibbsSample(
                signal_cr=C(zero, zero),
                ps=s.ps,
                fg_amps=C(zero, zero),
                chisq=jnp.mean(s.chisq, axis=(1, 2)),
                ln_post=s.ln_post,
            )
        return ps_new, s

    return jax.lax.scan(body, ps0, jnp.arange(niter))


run_chain_jit = jax.jit(
    run_chain,
    static_argnames=("niter", "map_estimate", "jitter", "store_cr", "solver",
                     "all_unflagged"),
)
