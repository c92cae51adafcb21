"""Time-dependent flags: per-flag-pattern time groups, one factorization
per group.

The reference driver carries an explicit FIXME for this
(/root/reference/run-hydra-pspec.py:541 collapses flags to the per-channel
"any time flagged" vector w_any) even though its sampler documents a
``(Ntimes, Nfreqs, Nfreqs)`` per-time Ninv
(/root/reference/hydra_pspec/pspec.py:336-340). Per-time factorizations
would cost Ntimes x the shared-factorization trick; instead, times are
grouped by their (usually few) distinct flag patterns: within a group the
GCR operator is constant, so the group's times remain one multi-RHS solve.
The bandpower draw then pools the delay statistics over ALL times (beta_k
sums over every group's sk; alpha keeps the total-times convention,
pspec.py:104-108) — the per-group systems share the one ps state.

Complex-engine implementation (models/gcr.py machinery); the batch-first
real-pair engine reuses the same grouping host-side via
``build_grouped_operators_real`` (models/rgibbs.py per group).
"""
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fourier import cfft
from ..ops.invgamma import sample_bandpowers_from_beta
from . import gcr, rgibbs


class TimeGroup(NamedTuple):
    ops: gcr.ChainOperators
    idx: np.ndarray  # static time indices of this group


def group_flag_patterns(flags_tf: np.ndarray):
    """Group times by identical flag pattern. ``flags_tf``: (Ntimes,
    Nfreqs) bool, uvh5 convention True = flagged. Returns a list of
    ``(w_g, idx_g)`` with ``w_g`` the per-channel weights (1 = keep) and
    ``idx_g`` the time indices, in first-appearance order."""
    flags_tf = np.asarray(flags_tf, dtype=bool)
    _, first, inverse = np.unique(
        flags_tf, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first)  # stable first-appearance ordering
    groups = []
    for rank, uidx in enumerate(order):
        idx = np.nonzero(inverse == uidx)[0]
        w_g = (~flags_tf[idx[0]]).astype(float)
        groups.append((w_g, idx))
    return groups


def build_grouped_operators(vis, flags_tf, fgmodes, ninv, dtype=None):
    """Per-group chain constants for the complex engine."""
    vis = np.asarray(vis)
    return [
        TimeGroup(
            ops=gcr.build_chain_operators(vis[idx], w_g, fgmodes, ninv,
                                          dtype=dtype),
            idx=idx,
        )
        for w_g, idx in group_flag_patterns(flags_tf)
    ]


def gibbs_step_tflags(
    key: jax.Array,
    ps: jax.Array,
    groups: Sequence[TimeGroup],
    ps_prior: jax.Array,
    map_estimate: bool = False,
    jitter: float = 0.0,
    prior_idx=None,
):
    """One Gibbs alternation with per-time-group GCR solves and a pooled
    bandpower draw. Returns ``(ps_new, GibbsSample)`` with full
    (Ntimes, Nfreqs) sample arrays reassembled in time order."""
    from .gibbs import GibbsSample

    ntimes_total = sum(int(g.idx.size) for g in groups)
    nfreqs = groups[0].ops.d_w.shape[-1]
    dtype = groups[0].ops.d_w.dtype
    rdtype = jnp.finfo(dtype).dtype
    k_ps = jax.random.fold_in(key, 999_983)

    signal_cr = jnp.zeros((ntimes_total, nfreqs), dtype=dtype)
    nmodes = groups[0].ops.fgmodes.shape[-1]
    fg_amps = jnp.zeros((ntimes_total, nmodes), dtype=dtype)
    chisq = jnp.zeros((ntimes_total, nfreqs), dtype=rdtype)
    beta = jnp.zeros((nfreqs,), dtype=rdtype)
    noise_term = jnp.asarray(0.0, dtype=rdtype)
    sig_beta_masked = jnp.zeros((nfreqs,), dtype=rdtype)

    for g, grp in enumerate(groups):
        ops = grp.ops
        nt = int(grp.idx.size)
        kg = jax.random.fold_in(key, g)
        k_a, k_b = jax.random.split(kg)
        if map_estimate:
            om_a = om_b = None
        else:
            om_a = jax.random.normal(k_a, (nt, nfreqs), dtype=dtype)
            om_b = jax.random.normal(k_b, (nt, nfreqs), dtype=dtype)
        res = gcr.gcr_solve(ops, ps, om_a, om_b, jitter=jitter)
        model = res.signal_cr + res.fg_amps @ ops.fgmodes.T
        resid = ops.d_w - model
        chisq_g = (jnp.abs(resid) ** 2) * ops.noise.ninv_full_diag
        sk_g = cfft(res.signal_cr, axis=-1)
        skm_g = cfft(res.signal_cr * ops.w, axis=-1)

        idx = grp.idx  # static
        signal_cr = signal_cr.at[idx].set(res.signal_cr)
        fg_amps = fg_amps.at[idx].set(res.fg_amps)
        chisq = chisq.at[idx].set(chisq_g.astype(rdtype))
        beta = beta + jnp.sum((sk_g * sk_g.conj()).real, axis=0).astype(rdtype)
        noise_term = noise_term + jnp.sum(
            ops.noise.apply_ni(resid).conj() * resid
        ).real.astype(rdtype)
        sig_beta_masked = sig_beta_masked + jnp.sum(
            (jnp.abs(skm_g) ** 2), axis=0
        ).astype(rdtype)

    ps_new = sample_bandpowers_from_beta(
        k_ps, beta, ntimes_total, ps_prior.astype(rdtype), prior_idx
    )
    sig_term = jnp.sum(
        sig_beta_masked / jnp.maximum(ps_new, jnp.finfo(rdtype).tiny)
    )
    ln_post = -(noise_term + sig_term)
    sample = GibbsSample(
        signal_cr=signal_cr,
        ps=ps_new.astype(rdtype),
        fg_amps=fg_amps,
        chisq=chisq,
        ln_post=ln_post.astype(rdtype),
    )
    return ps_new, sample


def run_chain_tflags(
    key, groups, ps0, ps_prior, niter: int,
    map_estimate: bool = False, jitter: float = 0.0, store_cr: bool = True,
    prior_idx=None,
):
    """``lax.scan`` over iterations of the grouped step (single chain)."""

    def body(ps, i):
        ps_new, s = gibbs_step_tflags(
            jax.random.fold_in(key, i), ps, groups, ps_prior,
            map_estimate=map_estimate, jitter=jitter, prior_idx=prior_idx,
        )
        if not store_cr:
            from .gibbs import GibbsSample

            zero = jnp.zeros((), dtype=s.ps.dtype)
            s = GibbsSample(
                signal_cr=zero, ps=s.ps, fg_amps=zero,
                chisq=jnp.mean(s.chisq), ln_post=s.ln_post,
            )
        return ps_new, s

    return jax.lax.scan(body, ps0, jnp.arange(niter))


# --- real-pair engine ---------------------------------------------------

class TimeGroupReal(NamedTuple):
    ops: rgibbs.RChainOperators
    idx: np.ndarray


def build_grouped_operators_real(vis, flags_tf, fgmodes, ninv,
                                 dtype=jnp.float32):
    """Per-group batch-of-one chain constants for the real-pair engine."""
    vis = np.asarray(vis)
    return [
        TimeGroupReal(
            ops=rgibbs.build_chain_operators(vis[idx], w_g, fgmodes, ninv,
                                             dtype=dtype),
            idx=idx,
        )
        for w_g, idx in group_flag_patterns(flags_tf)
    ]


def gibbs_step_tflags_real(
    key: jax.Array,
    ps: jax.Array,
    groups: Sequence[TimeGroupReal],
    ps_prior: jax.Array,
    map_estimate: bool = False,
    jitter: float = 0.0,
    prior_idx=None,
    solver: str = "auto",
    sids=None,
    igt_total=None,
):
    """Batch-first grouped step: ``ps`` is (B, Nfreqs); each group's ops
    carry the same leading batch of (baseline, chain) rows. Randomness is
    keyed per row on ``sids`` (global stream ids, default arange(B)) so the
    draws are batch-composition-invariant: batching same-flag-signature
    baselines together yields bit-identical chains to per-baseline runs
    (same guarantee as rgibbs.gibbs_step).

    ``igt_total``: inverse-gamma CDF table built at alpha + 1 =
    Ntimes_TOTAL for the pooled prior-bin draws. The per-group operator
    tables carry their GROUP's alpha and must not be used here (a latent
    wrong-shape bug before round 5 — unexercised because every tflags
    test ran with an empty prior); None falls back to the exact
    gammaincc-based truncated draw at the correct pooled alpha."""
    from ..ops import cplx
    from ..ops.cplx import C
    from .rgibbs import RGibbsSample, _t, gcr_solve as rgcr_solve

    batch = ps.shape[0]
    nfreqs = ps.shape[-1]
    ntimes_total = sum(int(g.idx.size) for g in groups)
    dtype = groups[0].ops.d_w.dtype
    if sids is None:
        sids = jnp.arange(batch)
    row_keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(sids)
    k_ps = jax.vmap(lambda k: jax.random.fold_in(k, 999_983))(row_keys)

    beta = jnp.zeros((batch, nfreqs), dtype=dtype)
    noise_term = jnp.zeros((batch,), dtype=dtype)
    sig_beta_masked = jnp.zeros((batch, nfreqs), dtype=dtype)
    sig_list, amp_list, chi_list = [], [], []

    for g, grp in enumerate(groups):
        ops = grp.ops
        nt = int(grp.idx.size)
        if map_estimate:
            om_a = om_b = None
        else:
            kg = jax.vmap(
                lambda k: jax.random.split(jax.random.fold_in(k, g))
            )(row_keys)                              # (B, 2) keys
            scale = np.sqrt(nfreqs).astype(np.float32)

            def draw(keys):
                return jax.vmap(
                    lambda k: cplx.standard_normal(
                        k, (nt, nfreqs), dtype=dtype
                    )
                )(keys)

            oa = draw(kg[:, 0])
            om_a = C(oa.re * scale, oa.im * scale)
            om_b = draw(kg[:, 1])
        signal_g, amps_g, sk_g = rgcr_solve(
            ops, ps, om_a, om_b, jitter=jitter, solver=solver
        )
        model = signal_g + cplx.matmul(amps_g, _t(ops.fg))
        resid = ops.d_w - model
        chi_g = resid.abs2() * ops.ninv_full_diag[:, None, :]
        skm = cplx.cfft_rows(
            C(signal_g.re * ops.w[:, None, :], signal_g.im * ops.w[:, None, :]),
            ops.f,
        )
        sig_list.append((grp.idx, signal_g))
        amp_list.append((grp.idx, amps_g))
        chi_list.append((grp.idx, chi_g))
        beta = beta + jnp.sum(sk_g.abs2(), axis=1)
        noise_term = noise_term + jnp.sum(
            ops.ni_diag[:, None, :] * resid.abs2(), axis=(1, 2)
        )
        sig_beta_masked = sig_beta_masked + jnp.sum(skm.abs2(), axis=1)

    # vmapped over per-row keys (the CDF table is batch-shared: alpha
    # = Ntimes_total - 1 is a signature constant)
    ps_new = jax.vmap(
        lambda k, b: sample_bandpowers_from_beta(
            k, b, ntimes_total, ps_prior, prior_idx, igt_total
        )
    )(k_ps, beta)
    sig_term = jnp.sum(
        sig_beta_masked / jnp.maximum(ps_new, jnp.finfo(dtype).tiny),
        axis=-1,
    )
    ln_post = -(noise_term + sig_term)

    def scatter(parts, width, is_c):
        if is_c:
            out = C(
                jnp.zeros((batch, ntimes_total, width), dtype=dtype),
                jnp.zeros((batch, ntimes_total, width), dtype=dtype),
            )
            for idx, v in parts:
                out = C(out.re.at[:, idx].set(v.re), out.im.at[:, idx].set(v.im))
            return out
        out = jnp.zeros((batch, ntimes_total, width), dtype=dtype)
        for idx, v in parts:
            out = out.at[:, idx].set(v)
        return out

    nmodes = groups[0].ops.fg.shape[-1]
    sample = RGibbsSample(
        signal_cr=scatter(sig_list, nfreqs, True),
        ps=ps_new,
        fg_amps=scatter(amp_list, nmodes, True),
        chisq=scatter(chi_list, nfreqs, False),
        ln_post=ln_post,
    )
    return ps_new, sample


def run_chain_tflags_real(
    key, groups, ps0, ps_prior, niter: int,
    map_estimate: bool = False, jitter: float = 0.0, store_cr: bool = True,
    prior_idx=None, solver: str = "auto", sids=None, igt_total=None,
):
    """Batch-first scanned chain of the grouped real-engine step.
    ``igt_total``: pooled-alpha CDF table (see gibbs_step_tflags_real)."""
    from ..ops.cplx import C
    from .rgibbs import RGibbsSample

    def body(ps, i):
        ps_new, s = gibbs_step_tflags_real(
            jax.random.fold_in(key, i), ps, groups, ps_prior,
            map_estimate=map_estimate, jitter=jitter, prior_idx=prior_idx,
            solver=solver, sids=sids, igt_total=igt_total,
        )
        if not store_cr:
            zero = jnp.zeros((), dtype=ps_new.dtype)
            s = RGibbsSample(
                signal_cr=C(zero, zero), ps=s.ps, fg_amps=C(zero, zero),
                chisq=jnp.mean(s.chisq, axis=(1, 2)), ln_post=s.ln_post,
            )
        return ps_new, s

    return jax.lax.scan(body, ps0, jnp.arange(niter))
