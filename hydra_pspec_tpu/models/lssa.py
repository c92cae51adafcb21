"""Least-Squares Spectral Analysis (LSSA) estimator.

Reference (hydra_pspec/lssa.py): fits a single complex sinusoid per delay
mode to flag-trimmed data by numerically minimizing the generalized
least-squares objective ``0.5 * Re[x^H C^{-1} x]`` with L-BFGS-B per tau
(lssa.py:192-207), then decorrelates the real/imaginary amplitudes with a
2x2 rotation (lssa.py:14-92).

The per-tau fit is a *linear* model in the complex amplitude
``z = A_re + i A_im`` (or ``amp * exp(i phase)``) — the GLS minimum is
closed-form:

    z*(tau) = (g^H H d) / (g^H H g),   g = taper * exp(-2 pi i tau nu),
    H = (C^{-1} + C^{-H}) / 2  (the objective only sees the Hermitian part).

All taus solve in one vmapped batch; no optimizer loop.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import C


def model_ap(amp, phase, tau, freqs):
    """Sinusoid model, amplitude/phase form (reference lssa.py:6-7)."""
    return amp * jnp.exp(-2.0j * jnp.pi * tau * freqs + 1.0j * phase)


def model_aa(A_re, A_im, tau, freqs):
    """Sinusoid model, re/im amplitude form (reference lssa.py:10-11)."""
    return (A_re + 1.0j * A_im) * jnp.exp(-2.0j * jnp.pi * tau * freqs)


def default_tau(freqs):
    """Delay grid in nanoseconds, ``fftfreq(n, d=dfreq_MHz) * 1e3``
    (reference lssa.py:160)."""
    freqs = np.asarray(freqs)
    return np.fft.fftfreq(n=freqs.size, d=freqs[1] - freqs[0]) * 1e3


@partial(jax.jit, static_argnames=("fit_amp_phase",))
def lssa_fit_modes(d, freqs, invcov=None, fit_amp_phase=True, tau=None, taper=None):
    """Weighted LSSA fit to masked complex 1D data (flagged channels already
    removed, cf. utils.trim_flagged_channels). API mirror of reference
    lssa.py:95-208; returns ``(tau, param1, param2)`` where the params are
    (amp, phase) or (A_re, A_im).

    NOTE: the reference keeps the raw MHz/ns unit mix in the model phase
    (``exp(-2 pi i tau_ns * freq_MHz)``, lssa.py:7,160) — we reproduce that
    exactly for parity; pass an explicit ``tau`` for different conventions.
    """
    d = jnp.asarray(d)
    freqs = jnp.asarray(freqs, dtype=jnp.result_type(float))
    if tau is None:
        tau = jnp.fft.fftfreq(freqs.size, d=freqs[1] - freqs[0]) * 1e3
    else:
        tau = jnp.asarray(tau)
    if invcov is None:
        invcov = jnp.eye(d.size, dtype=d.dtype)
    if taper is None:
        taper = jnp.ones_like(freqs)
    H = 0.5 * (invcov + invcov.conj().T)

    def fit_one(t):
        g = taper * jnp.exp(-2.0j * jnp.pi * t * freqs)
        hd = H @ (taper * d)
        num = jnp.vdot(g, hd)          # g^H H d
        den = jnp.vdot(g, H @ g).real  # g^H H g  (real for Hermitian H)
        z = num / jnp.maximum(den, jnp.finfo(den.dtype).tiny)
        return z

    z = jax.vmap(fit_one)(tau)
    if fit_amp_phase:
        amp = jnp.abs(z)
        phase = jnp.angle(z) % (2.0 * jnp.pi)
        return tau, amp, phase
    return tau, z.real, z.imag


@partial(jax.jit, static_argnames=("fit_amp_phase",))
def lssa_fit_modes_rp(d: C, freqs, invcov: C = None, fit_amp_phase=True,
                      tau=None, taper=None):
    """Real-pair twin of :func:`lssa_fit_modes` — no complex dtypes
    anywhere, so it runs at float32 on the device
    (reference estimators are CPU-only, hydra_pspec/lssa.py:95; this is
    the on-device path). ``d``/``invcov`` are ``ops.cplx.C`` pairs.

    Same closed-form GLS: z*(tau) = (g^H H d) / (g^H H g) with
    g = taper * exp(-2 pi i tau freqs) and H the Hermitian part of
    ``invcov``. Matches the complex implementation to dtype precision
    (pinned in tests/test_estimators.py)."""
    freqs = jnp.asarray(freqs, dtype=d.re.dtype)
    n = d.re.shape[-1]
    if tau is None:
        tau = (jnp.fft.fftfreq(n, d=freqs[1] - freqs[0]) * 1e3).astype(
            freqs.dtype)
    else:
        tau = jnp.asarray(tau, dtype=freqs.dtype)
    if invcov is None:
        eye = jnp.eye(n, dtype=freqs.dtype)
        invcov = C(eye, jnp.zeros_like(eye))
    if taper is None:
        taper = jnp.ones_like(freqs)
    # Hermitian part: H = (A + A^H) / 2
    H = C(0.5 * (invcov.re + invcov.re.T), 0.5 * (invcov.im - invcov.im.T))
    td = C(taper * d.re, taper * d.im)
    # hd = H @ (taper * d) — one matvec shared by every tau
    hd = C(H.re @ td.re - H.im @ td.im, H.re @ td.im + H.im @ td.re)

    def fit_one(t):
        ph = -2.0 * jnp.pi * t * freqs
        g = C(taper * jnp.cos(ph), taper * jnp.sin(ph))
        # num = g^H hd ; den = Re[g^H H g] (real for Hermitian H)
        num = C(jnp.sum(g.re * hd.re + g.im * hd.im),
                jnp.sum(g.re * hd.im - g.im * hd.re))
        hg = C(H.re @ g.re - H.im @ g.im, H.re @ g.im + H.im @ g.re)
        den = jnp.sum(g.re * hg.re + g.im * hg.im)
        den = jnp.maximum(den, jnp.finfo(den.dtype).tiny)
        return C(num.re / den, num.im / den)

    z = jax.vmap(fit_one)(tau)
    if fit_amp_phase:
        amp = jnp.sqrt(z.abs2())
        phase = jnp.arctan2(z.im, z.re) % (2.0 * jnp.pi)
        return tau, amp, phase
    return tau, z.re, z.im


@jax.jit
def decorr_matrix(w, tau, freqs):
    """2x2 rotation decorrelating the masked cos/sin overlap for one tau
    (Eq. 8 of "Bryna's note"; reference lssa.py:14-69). Returns
    ``(rot, eigvals)``."""
    w = jnp.asarray(w, dtype=jnp.result_type(float))
    c = w * jnp.cos(2.0 * jnp.pi * tau * freqs)
    s = w * jnp.sin(2.0 * jnp.pi * tau * freqs)
    cc, ss, cs = jnp.sum(c * c), jnp.sum(s * s), jnp.sum(c * s)
    theta = 0.5 * jnp.arctan2(2.0 * cs, cc - ss)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    rot = jnp.array([[ct, st], [-st, ct]])
    cov = jnp.array([[cc, cs], [cs, ss]])
    eigvals = jnp.diagonal(rot @ cov @ rot.T)
    return rot, eigvals


@jax.jit
def decorr_pspec(A_re, A_im, w, tau, freqs):
    """LSSA power spectrum with decorrelation re-weighting (reference
    lssa.py:73-92), vmapped over the tau grid."""
    freqs = jnp.asarray(freqs, dtype=jnp.result_type(float))

    def one(t, ar, ai):
        rot, ev = decorr_matrix(w, t, freqs)
        a1, a2 = rot @ jnp.array([ar, ai])
        return ((a1 * ev[1]) ** 2 + (a2 * ev[0]) ** 2) / (
            ev[0] ** 2 + ev[1] ** 2
        )

    return jax.vmap(one)(jnp.asarray(tau), jnp.asarray(A_re), jnp.asarray(A_im))
