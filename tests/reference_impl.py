"""NumPy/SciPy oracle implementing the *reference semantics* of
hydra-pspec's Gibbs step (see /root/reference/hydra_pspec/pspec.py), written
independently from the math for use as a test oracle and as the CPU
baseline for benchmarking. Deliberately mirrors the reference's algorithmic
choices (dense block A, sqrtm, per-time CG with pinv preconditioner) rather
than our formulation, so agreement between the two is meaningful.
"""
import numpy as np
import scipy.linalg
import scipy.sparse.linalg
from scipy.stats import invgamma


def fourier_operator(n):
    i = (np.arange(n) - n // 2).reshape(1, -1)
    k = (np.arange(n) - n // 2).reshape(-1, 1)
    return np.exp(-2j * np.pi * (i * k) / n)


def covariance_from_pspec(ps, F):
    return F.conj().T @ np.diag(ps).astype(complex) @ F


def psd_sqrt(m):
    """Principal square root of a Hermitian PSD matrix — what
    ``scipy.linalg.sqrtm`` returns for one, but through ``eigh``: sqrtm's
    Schur recurrence divides 0 by 0 when two eigenvalues are zero, as a
    flag-masked Ni has, and some SciPy versions return NaN there."""
    vals, vecs = np.linalg.eigh(m)
    return (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.conj().T


def build_matrices(w, signal_S, Ninv, fgmodes):
    """Reference pspec.py:325-374 semantics: operators + block A + pinv."""
    nfreqs = signal_S.shape[0]
    if Ninv.ndim == 1:
        Ninv = np.diag(Ninv)
    Sh = scipy.linalg.sqrtm(signal_S)
    Ni = w[:, None] * Ninv * w[None, :]
    Nih = psd_sqrt(Ni)
    nparams = nfreqs + fgmodes.shape[1]
    A = np.zeros((nparams, nparams), dtype=complex)
    A[:nfreqs, :nfreqs] = np.eye(nfreqs) + signal_S @ Ni
    A[:nfreqs, nfreqs:] = signal_S @ Ni @ fgmodes
    A[nfreqs:, :nfreqs] = fgmodes.conj().T @ Ni
    A[nfreqs:, nfreqs:] = fgmodes.conj().T @ Ni @ fgmodes
    return dict(Sh=Sh, S=signal_S, Ni=Ni, Nih=Nih, A=A)


def gcr_rhs(mats, fgmodes, d_w_t, omega_a_t, omega_b_t):
    """Reference pspec.py:219-222 RHS for one time sample."""
    S, Sh, Ni, Nih = mats["S"], mats["Sh"], mats["Ni"], mats["Nih"]
    nfreqs = S.shape[0]
    nmodes = fgmodes.shape[1]
    b = np.zeros(nfreqs + nmodes, dtype=complex)
    b[:nfreqs] = S @ Ni @ d_w_t + Sh @ omega_a_t + S @ Nih @ omega_b_t
    b[nfreqs:] = fgmodes.conj().T @ (Ni @ d_w_t + Nih @ omega_b_t)
    return b


def gcr_solve_direct(mats, fgmodes, d_w, omega_a, omega_b):
    """Exact dense solve of the reference system for all times; the oracle
    counterpart of the reference's per-time CG (pspec.py:228)."""
    ntimes, nfreqs = d_w.shape
    nmodes = fgmodes.shape[1]
    B = np.stack(
        [
            gcr_rhs(mats, fgmodes, d_w[t], omega_a[t], omega_b[t])
            for t in range(ntimes)
        ],
        axis=1,
    )
    X = np.linalg.solve(mats["A"], B)
    return X[:nfreqs].T, X[nfreqs:].T  # signal_cr, fg_amps


def gcr_solve_cg(mats, fgmodes, d_w, omega_a, omega_b, rtol=1e-8, atol=1e-6):
    """Per-time preconditioned CG exactly as the reference runs it
    (pspec.py:228: M = pinv(A), maxiter 1e5) — used for baseline timing."""
    ntimes, nfreqs = d_w.shape
    nmodes = fgmodes.shape[1]
    Ai = np.linalg.pinv(mats["A"])
    out = np.zeros((ntimes, nfreqs + nmodes), dtype=complex)
    for t in range(ntimes):
        b = gcr_rhs(mats, fgmodes, d_w[t], omega_a[t], omega_b[t])
        x, info = scipy.sparse.linalg.cg(
            mats["A"], b, maxiter=int(1e5), rtol=rtol, atol=atol,
            M=scipy.sparse.linalg.aslinearoperator(Ai),
        )
        out[t] = x
    return out[:, :nfreqs], out[:, nfreqs:]


def delay_transform(s):
    """Centered FFT over the last axis (reference pspec.py:91-95)."""
    return np.fft.fftshift(
        np.fft.fft(np.fft.ifftshift(s, axes=-1), axis=-1), axes=-1
    )


def sample_S_beta_alpha(signal_cr):
    sk = delay_transform(signal_cr)
    beta = np.sum(np.abs(sk) ** 2, axis=0)
    alpha = signal_cr.shape[0] - 1.0
    return beta, alpha


def truncated_invgamma_oracle(u, alpha, beta, lo, hi, ngrid=1000):
    """Reference inversion sampler (pspec.py:11-64) with injectable u."""
    x = np.logspace(np.log10(lo), np.log10(hi), ngrid)
    cdf = invgamma.cdf(x, a=alpha, loc=0, scale=beta)
    cdf = cdf - cdf.min()
    cdf = cdf / cdf.max()
    cdf_u, idx = np.unique(cdf, return_index=True)
    return float(np.interp(u, cdf_u, x[idx]))


def chisq_and_lnpost(d_w, w, signal_cr, fg_amps, fgmodes, Ninv, ps_sample):
    """Reference diagnostics (pspec.py:447-485), boolean-mask form."""
    if Ninv.ndim == 1:
        Ninv = np.diag(Ninv)
    nfreqs = d_w.shape[1]
    model = signal_cr + fg_amps @ fgmodes.T
    chisq = np.abs(d_w - model) ** 2 * np.diagonal(Ninv).real[None, :]
    F = fourier_operator(nfreqs)
    S_sample = covariance_from_pspec(ps_sample / nfreqs**2, F)
    Sinv = np.linalg.inv(S_sample)
    flags = w.astype(bool)
    r = (d_w - model)[:, flags]
    s = signal_cr[:, flags]
    t1 = np.sum(np.diagonal(-(r.conj() @ Ninv[np.ix_(flags, flags)] @ r.T)))
    t2 = np.sum(np.diagonal(-(s.conj() @ Sinv[np.ix_(flags, flags)] @ s.T)))
    return chisq, float((t1 + t2).real)
