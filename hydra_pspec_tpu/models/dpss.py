"""DPSS (discrete prolate spheroidal sequence) foreground mode fitting.

Reference (hydra_pspec/dpss.py:7-94): fits ``nmodes`` DPSS basis functions
to masked complex data by L-BFGS-B minimization of
``0.5 Re[x^H C^{-1} x]`` over interleaved real/imag coefficients.

The model is linear in the complex coefficients ``z_k`` applied to *real*
basis vectors, so the GLS minimum is closed form: with weighted design
``Phi = (taper * w)[:, None] * basis`` and ``H`` the Hermitian part of
``C^{-1}``,

    (Phi^T H Phi) z = Phi^T H (taper * w * d).

The DPSS basis itself is computed on host with scipy (a one-time
eigenproblem — not a hot op); the fit is jittable JAX.
"""
import jax
import jax.numpy as jnp
import numpy as np


def dpss_basis(nfreqs: int, nmodes: int, alpha: float = 1.0) -> np.ndarray:
    """DPSS basis, shape (nmodes, nfreqs) — ``scipy.signal.windows.dpss``
    with ``NW=alpha, Kmax=nmodes, sym=False`` (reference dpss.py:69-72)."""
    from scipy.signal.windows import dpss as _dpss

    return np.asarray(_dpss(nfreqs, NW=alpha, Kmax=nmodes, sym=False))


def dpss_operator(nfreqs: int, nmodes: int, alpha: float = 1.0) -> np.ndarray:
    """DPSS modes as a (Nfreqs, Nmodes) column basis — drop-in for the
    driver's ``fgmodes`` input (run-hydra-pspec.py:440-460 uses PCA
    eigenvectors or Legendre polynomials; DPSS is the standard smooth
    foreground basis the reference's dpss.py targets)."""
    return dpss_basis(nfreqs, nmodes, alpha).T


def dpss_fit_modes(d, w, freqs, cov, nmodes=10, alpha=1.0, taper=None):
    """Closed-form GLS DPSS fit; API mirror of reference dpss.py:7-94.

    Returns ``(dpss_modes, amps)`` with ``dpss_modes`` shaped
    (nmodes, nfreqs) and ``amps`` the 2*nmodes real vector of interleaved
    re/im coefficients (matching the reference optimizer's packing,
    dpss.py:80,89).
    """
    d = jnp.asarray(d)
    nfreqs = d.shape[-1]
    modes = jnp.asarray(dpss_basis(nfreqs, nmodes, alpha))
    w = jnp.asarray(w, dtype=jnp.result_type(float))
    if taper is None:
        taper = jnp.ones(nfreqs)
    else:
        taper = jnp.asarray(taper)
    invcov = jnp.linalg.inv(jnp.asarray(cov))
    H = 0.5 * (invcov + invcov.conj().T)

    weight = taper * w
    phi = (weight[:, None] * modes.T).astype(H.dtype)     # (nfreqs, nmodes)
    rhs = phi.conj().T @ (H @ (weight * d))
    gram = phi.conj().T @ H @ phi
    z = jnp.linalg.solve(gram, rhs)

    amps = jnp.stack([z.real, z.imag], axis=-1).reshape(-1)
    return modes, amps


def dpss_fit_modes_rp(d, w, freqs, cov, nmodes=10, alpha=1.0, taper=None):
    """Real-pair twin of :func:`dpss_fit_modes` — no complex dtypes, so it
    runs at float32 on the device (the reference's
    optimizer loop is CPU-only, hydra_pspec/dpss.py:78-89). ``d`` and
    ``cov`` are ``ops.cplx.C`` pairs; returns the same
    ``(dpss_modes, amps)`` with interleaved re/im coefficients."""
    from ..ops import cplx
    from ..ops.cplx import C

    nfreqs = d.re.shape[-1]
    fdt = d.re.dtype
    modes = jnp.asarray(dpss_basis(nfreqs, nmodes, alpha), dtype=fdt)
    w = jnp.asarray(w, dtype=fdt)
    taper = jnp.ones(nfreqs, fdt) if taper is None else jnp.asarray(taper, fdt)

    invcov = cplx.hermitian_inverse(cov)
    H = C(0.5 * (invcov.re + invcov.re.T), 0.5 * (invcov.im - invcov.im.T))

    weight = taper * w
    phi = weight[:, None] * modes.T                       # (nfreqs, nmodes) real
    wd = C(weight * d.re, weight * d.im)
    hd = C(H.re @ wd.re - H.im @ wd.im, H.re @ wd.im + H.im @ wd.re)
    rhs = C(phi.T @ hd.re, phi.T @ hd.im)                 # (nmodes,)
    gram = C(phi.T @ H.re @ phi, phi.T @ H.im @ phi)      # Hermitian
    z = cplx.hermitian_solve(gram, C(rhs.re[:, None], rhs.im[:, None]))
    amps = jnp.stack([z.re[:, 0], z.im[:, 0]], axis=-1).reshape(-1)
    return modes, amps


def dpss_model(modes, amps):
    """Reconstruct the fitted foreground model from interleaved re/im
    coefficients (reference loglike model, dpss.py:80-81)."""
    amps = jnp.asarray(amps)
    z = amps[0::2] + 1.0j * amps[1::2]
    return jnp.sum(z[:, None] * jnp.asarray(modes), axis=0)
