"""Inverse-gamma bandpower sampling, including the truncated (bounded-prior)
variant via log-grid CDF inversion.

Reference semantics (hydra_pspec/pspec.py:11-127):
  * ``beta_k = sum_t |sk[t, k]|^2`` over the delay transform of the signal
    constrained realizations; ``alpha = Ntimes - 1`` (complex-data
    convention, pspec.py:104-108).
  * Unbounded bins: ``x = beta / Gamma(alpha)`` (equivalently
    ``invgamma.rvs(a=alpha) * beta``, pspec.py:125).
  * Bounded bins (prior > 0): inversion sampling of an inverse-gamma with
    shape ``alpha + 1`` (the log-uniform prior folds in an extra ``1/x``,
    pspec.py:113-123) on a 1000-point log grid between the prior bounds
    (pspec.py:50-62).

Everything is vectorized over delay bins; both branches are evaluated for
every bin and selected with ``jnp.where`` (static shapes, no host control
flow), which is the XLA-friendly equivalent of the reference's per-bin
Python loop (pspec.py:113-125).
"""
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fourier import cfft
from .special import gammaincc_fixed

_NGRID = 1000  # matches the reference's default interpolation grid


def invgamma_cdf(x, alpha, beta, iters=None):
    """CDF of InverseGamma(alpha, scale=beta):
    ``P(X <= x) = Q(alpha, beta / x)`` (upper regularized gamma).
    Uses the fixed-trip-count implementation — jax.scipy's gammaincc is a
    data-dependent while_loop (see ops/special.py). ``iters``:
    static trip-count pair for alpha > ~2000 (ops.special.iters_for_shape)."""
    return gammaincc_fixed(alpha, beta / x, iters=iters)


@partial(jax.jit, static_argnames=("ngrid", "iters"))
def truncated_invgamma_sample(u, alpha, beta, lo, hi, ngrid: int = _NGRID,
                              iters=None):
    """Inverse-CDF draw from InverseGamma(alpha, scale=beta) truncated to
    ``[lo, hi]``, given a uniform variate ``u`` in [0, 1).

    Follows the reference's method (pspec.py:50-62): evaluate the CDF on a
    log-spaced grid over the bounds, renormalize to [0, 1] over the
    truncation region, then linearly interpolate the inverse CDF at ``u``.
    Flat (duplicate) CDF regions are handled with a clamped-denominator
    interpolation instead of the reference's ``np.unique`` dedupe — both
    pick the boundary of the flat region.

    All arguments may be broadcastable arrays; the grid axis is internal.
    """
    u, alpha, beta, lo, hi = jnp.broadcast_arrays(
        *[jnp.asarray(a, dtype=jnp.result_type(float)) for a in (u, alpha, beta, lo, hi)]
    )
    # log-spaced grid between bounds: shape (..., ngrid)
    t = jnp.linspace(0.0, 1.0, ngrid)
    log_lo = jnp.log10(lo)[..., None]
    log_hi = jnp.log10(hi)[..., None]
    x = 10.0 ** (log_lo + (log_hi - log_lo) * t)
    cdf = invgamma_cdf(x, alpha[..., None], beta[..., None], iters=iters)
    cdf = cdf - cdf[..., :1]
    denom = jnp.maximum(cdf[..., -1:], jnp.finfo(cdf.dtype).tiny)
    cdf = cdf / denom
    # Inverse interpolation of (cdf, x) at u. cdf is monotone nondecreasing.
    idx = jnp.clip(
        jnp.sum((cdf < u[..., None]).astype(jnp.int32), axis=-1), 1, ngrid - 1
    )
    c0 = jnp.take_along_axis(cdf, (idx - 1)[..., None], axis=-1)[..., 0]
    c1 = jnp.take_along_axis(cdf, idx[..., None], axis=-1)[..., 0]
    x0 = jnp.take_along_axis(x, (idx - 1)[..., None], axis=-1)[..., 0]
    x1 = jnp.take_along_axis(x, idx[..., None], axis=-1)[..., 0]
    frac = (u - c0) / jnp.maximum(c1 - c0, jnp.finfo(cdf.dtype).tiny)
    frac = jnp.clip(frac, 0.0, 1.0)
    return x0 + frac * (x1 - x0)


class InvGammaTable(NamedTuple):
    """Tabulated regularized upper gamma ``Q(alpha, y)`` on a log-spaced
    ``y`` grid — the fast path for truncated inverse-gamma draws.

    The shape parameter is a *chain constant* (alpha + 1 = Ntimes,
    pspec.py:104-123), so the entire CDF family the sampler ever evaluates
    is the one-dimensional function ``P(X <= x) = Q(alpha, beta / x)``
    with only ``beta`` changing per iteration. A 4096-point table built
    once per chain (host-side, float64 scipy) turns each draw into two
    table lookups and one inverse interpolation, where an iterative
    gammaincc evaluation under scan is a loop of dependent steps."""

    log_y: jax.Array   # (size,) increasing
    q: jax.Array       # (size,) Q(alpha, y), decreasing in y
    alpha: jax.Array   # () — recorded for provenance/checks


def make_invgamma_table(alpha: float, size: int = 4096, tail: float = 60.0,
                        dtype=jnp.float32) -> InvGammaTable:
    """Host-side table build covering ``y`` in
    ``[max(alpha - tail*sqrt(alpha), eps), alpha + tail*sqrt(alpha)]``
    extended by decades — Q saturates to 1/0 outside and the sampler clamps
    there (equivalent to the reference's CDF-dedupe saturation,
    pspec.py:55-57)."""
    import numpy as np
    from scipy.special import gammaincc as _sp_q

    a = float(alpha)
    lo = max(a / 1e4, 1e-30)
    hi = a + tail * np.sqrt(max(a, 1.0)) + 10.0
    y = np.logspace(np.log10(lo), np.log10(hi), size)
    q = _sp_q(a, y)
    return InvGammaTable(
        log_y=jnp.asarray(np.log(y), dtype=dtype),
        q=jnp.asarray(q, dtype=dtype),
        alpha=jnp.asarray(a, dtype=dtype),
    )


def _table_q_at(table: InvGammaTable, y):
    """Q(alpha, y) by linear interpolation in log y (clamped at the ends)."""
    ly = jnp.log(jnp.maximum(y, jnp.finfo(y.dtype).tiny))
    size = table.log_y.shape[0]
    idx = jnp.clip(jnp.searchsorted(table.log_y, ly), 1, size - 1)
    l0 = table.log_y[idx - 1]
    l1 = table.log_y[idx]
    q0 = table.q[idx - 1]
    q1 = table.q[idx]
    t = jnp.clip((ly - l0) / jnp.maximum(l1 - l0, 1e-30), 0.0, 1.0)
    return q0 + t * (q1 - q0)


def _table_y_at(table: InvGammaTable, c):
    """Inverse of the table: y with Q(alpha, y) = c. ``q`` is decreasing,
    so search the reversed array."""
    size = table.q.shape[0]
    qr = table.q[::-1]
    lyr = table.log_y[::-1]
    idx = jnp.clip(jnp.searchsorted(qr, c), 1, size - 1)
    q0 = qr[idx - 1]
    q1 = qr[idx]
    l0 = lyr[idx - 1]
    l1 = lyr[idx]
    t = jnp.clip((c - q0) / jnp.maximum(q1 - q0, 1e-30), 0.0, 1.0)
    return jnp.exp(l0 + t * (l1 - l0))


def truncated_invgamma_sample_table(u, beta, lo, hi, table: InvGammaTable):
    """Truncated InverseGamma(alpha, scale=beta) inverse-CDF draw on
    ``[lo, hi]`` via the precomputed table: exact inversion sampling (to
    table resolution), no per-draw grid."""
    p_lo = _table_q_at(table, beta / lo)
    p_hi = _table_q_at(table, beta / hi)
    c = p_lo + u * (p_hi - p_lo)
    y = _table_y_at(table, c)
    x = beta / jnp.maximum(y, jnp.finfo(beta.dtype).tiny)
    return jnp.clip(x, lo, hi)


def inversion_sample_invgamma(alpha, beta, prior_min, prior_max, *, key, ngrid=_NGRID):
    """Single-draw convenience wrapper mirroring the reference API and its
    input validation (pspec.py:40-47) but taking an explicit PRNG ``key``."""
    import numpy as np

    if np.ndim(prior_min) == 0 and not isinstance(prior_min, jax.core.Tracer):
        if prior_min <= 0:
            raise ValueError("prior_min must be greater than zero")
        if prior_max <= 0:
            raise ValueError("prior_max must be greater than zero")
        if not np.isfinite(prior_max):
            raise ValueError("prior_max must be finite")
        if prior_max <= prior_min:
            raise ValueError("prior_max must be greater than prior_min")
    u = jax.random.uniform(key)
    return truncated_invgamma_sample(u, alpha, beta, prior_min, prior_max, ngrid=ngrid)


@jax.jit
def sample_bandpowers(key, sk, prior, prior_idx=None):
    """Draw delay power spectrum bandpowers given delay-space signal samples.

    Parameters
    ----------
    key : PRNG key.
    sk : (Ntimes, Nfreqs) complex — centered delay transform of the signal
        constrained realizations.
    prior : (2, Nfreqs) real — [0] upper and [1] lower bound per bin; a bin
        is bounded iff either entry is > 0 (reference pspec.py:114).

    Returns
    -------
    ps : (Nfreqs,) real bandpower sample.
    """
    ntimes = sk.shape[0]
    beta = jnp.sum((sk * sk.conj()).real, axis=0)
    return sample_bandpowers_from_beta(key, beta, ntimes, prior, prior_idx)


@partial(jax.jit, static_argnums=(2,))
def sample_bandpowers_from_beta(key, beta, ntimes, prior, prior_idx=None,
                                table=None):
    """Bandpower conditional draw from the sufficient statistic
    ``beta_k = sum_t |sk[t, k]|^2`` — shared by the complex and real-pair
    execution engines.

    ``prior_idx`` (optional, static length): indices of the bins that can
    carry a prior. When given, the grid-inversion work runs only on those
    bins — the reference's prior window covers ~7 of 120 bins
    (run-hydra-pspec.py:509-517), so this cuts the truncated-sampler cost
    ~17x. Bins listed in prior_idx but with zero prior still get the free
    draw (selection is by prior values, exactly as without prior_idx).
    """
    real_dtype = beta.dtype
    alpha = jnp.asarray(ntimes - 1.0, dtype=real_dtype)
    # ntimes is static, so the trip counts of the gammaincc evaluation can
    # follow the shape parameter (the fixed defaults degrade above a~2000).
    from .special import iters_for_shape

    gi_iters = iters_for_shape(float(ntimes) + 1.0)

    k_gamma, k_u = jax.random.split(key)
    # Unbounded: x = beta / Gamma(alpha, 1). beta may carry leading batch
    # axes (the batch-first real engine). alpha = ntimes - 1 is an integer,
    # so Gamma(alpha, 1) = -sum of alpha log-uniforms EXACTLY — three dense
    # ops instead of jax.random.gamma's rejection sampler (a
    # data-dependent while_loop that costs ~ms on this backend). Falls
    # back to the rejection sampler for very long time axes (memory).
    alpha_int = int(ntimes) - 1
    if alpha_int == round(alpha_int) and 0 < alpha_int <= 512:
        u = jax.random.uniform(
            k_gamma, (alpha_int,) + beta.shape, dtype=real_dtype)
        g = -jnp.sum(jnp.log(jnp.maximum(u, jnp.finfo(real_dtype).tiny)),
                     axis=0)
    else:
        g = jax.random.gamma(k_gamma, alpha, shape=beta.shape,
                             dtype=real_dtype)
    free = beta / g

    def draw_trunc(u, b, lo, hi):
        if table is not None:
            return truncated_invgamma_sample_table(u, b, lo, hi, table)
        return truncated_invgamma_sample(u, alpha + 1.0, b, lo, hi,
                                         iters=gi_iters)

    if prior_idx is None:
        u = jax.random.uniform(k_u, beta.shape, dtype=real_dtype)
        has_prior = jnp.any(prior > 0, axis=0)
        lo = jnp.where(has_prior, prior[1], 1.0)
        hi = jnp.where(has_prior, prior[0], 10.0)
        bounded = draw_trunc(u, beta, lo, hi)
        return jnp.where(has_prior, bounded, free)

    prior_idx = jnp.asarray(prior_idx)
    npb = prior_idx.shape[0]
    u = jax.random.uniform(k_u, beta.shape[:-1] + (npb,), dtype=real_dtype)
    p_sub = prior[:, prior_idx]
    has_prior = jnp.any(p_sub > 0, axis=0)
    lo = jnp.where(has_prior, p_sub[1], 1.0)
    hi = jnp.where(has_prior, p_sub[0], 10.0)
    bounded = draw_trunc(u, beta[..., prior_idx], lo, hi)
    vals = jnp.where(has_prior, bounded, free[..., prior_idx])
    return free.at[..., prior_idx].set(vals)


def sample_S(key, s=None, sk=None, prior=None):
    """Bandpower conditional draw from real-space (``s``) or delay-space
    (``sk``) signal samples — API mirror of reference pspec.py:67-127."""
    if s is None and sk is None:
        raise ValueError("Must pass in s (real space) or sk (Fourier space).")
    if sk is None:
        sk = cfft(s, axis=-1)
    if prior is None:
        prior = jnp.zeros((2, sk.shape[-1]))
    return sample_bandpowers(key, sk, prior)


def sprior(signals, bins: int, factor: float):
    """Build a ``(2, Nfreqs)`` bandpower prior window from true signals
    (reference pspec.py:130-148): bounds ``ds * factor`` / ``ds / factor``
    within ``bins`` of delay 0 (wrap-ordered), zero elsewhere, normalized by
    ``(Ntimes / 2 - 1)``."""
    signals = jnp.asarray(signals)
    nobs, nfreq = signals.shape
    sk = jnp.fft.fft(signals, axis=-1)
    ds = jnp.sum((sk * sk.conj()).real, axis=0)
    prior = jnp.stack([ds * factor, ds / factor])
    mask = jnp.zeros(nfreq, dtype=bool).at[: bins + 1].set(True)
    mask = mask.at[-bins:].set(True) if bins > 0 else mask
    prior = prior * mask[None, :]
    return prior / (nobs / 2 - 1)
