"""Centered Fourier operators and delay-spectrum transforms.

Semantics match the reference's centered DFT convention
(hydra_pspec/utils.py:15-41): multiplying by ``fourier_operator(n)`` equals
``fftshift(fft(ifftshift(x)))``. The delay axis is always the *last* axis
and is fftshifted so the monopole (delay 0) sits at index ``n // 2``.

The matrix form is used where a dense frequency-frequency operator must be
assembled for the GCR system (the matrices are ~128x128); everywhere a
transform is merely *applied* to data we use the FFT form (``cfft``),
which XLA lowers to its native FFT.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def fourier_operator(n: int, dtype=None) -> jax.Array:
    """Centered DFT matrix ``F[k, x] = exp(-2 pi i k x / n)`` with both
    indices offset by ``n // 2`` (reference: hydra_pspec/utils.py:15-41).

    Properties used throughout the sampler (unnormalized DFT):
      * ``F @ F^H = n * I``, so ``F^{-1} = F^H / n``.
      * ``F`` is complex-symmetric: ``F.T == F``.
      * ``(F^H diag(a) F) @ (F^H diag(b) F) = n * F^H diag(a*b) F``.
    """
    if dtype is None:
        dtype = jnp.complex128 if jax.config.jax_enable_x64 else jnp.complex64
    i = np.arange(n) - n // 2
    phase = np.outer(i, i) * (-2.0 * np.pi / n)
    # Build on host at float64 precision, then cast: the matrix is constant.
    op = np.exp(1j * phase)
    return jnp.asarray(op, dtype=dtype)


def cfft(x: jax.Array, axis: int = -1) -> jax.Array:
    """Centered FFT: ``fftshift(fft(ifftshift(x)))`` along ``axis``.

    Equivalent to left-multiplying by ``fourier_operator(n)`` (for the last
    axis), cf. reference pspec.py:91-95 where the delay transform of the
    signal CR is taken this way.
    """
    x = jnp.fft.ifftshift(x, axes=axis)
    x = jnp.fft.fft(x, axis=axis)
    return jnp.fft.fftshift(x, axes=axis)


def icfft(x: jax.Array, axis: int = -1) -> jax.Array:
    """Inverse of :func:`cfft`."""
    x = jnp.fft.ifftshift(x, axes=axis)
    x = jnp.fft.ifft(x, axis=axis)
    return jnp.fft.fftshift(x, axes=axis)


def covariance_from_pspec(ps: jax.Array, fourier_op: jax.Array) -> jax.Array:
    """Frequency-frequency covariance ``C = F^H diag(ps) F`` from bandpowers
    (reference: pspec.py:313-322). ``ps`` carries whatever FFT normalization
    the caller applied (the Gibbs step divides by ``Nfreqs**2``,
    pspec.py:464)."""
    ps = ps.astype(fourier_op.dtype)
    return (fourier_op.conj().T * ps) @ fourier_op


def pspec_from_covariance(C: jax.Array, fourier_op: jax.Array) -> jax.Array:
    """Project a frequency-frequency covariance onto delay-diagonal
    bandpowers ``ps = diag(F C F^H) / n^2`` — the exact inverse of
    :func:`covariance_from_pspec` when ``C`` is delay-diagonal, and the
    natural delay-stationary approximation otherwise. Used to convert a
    user-supplied ``S_initial`` (run-hydra-pspec.py:417-425) into the
    ``ps``-parameterized sampler state."""
    n = C.shape[-1]
    diag = jnp.einsum("ki,...ij,kj->...k", fourier_op, C, fourier_op.conj())
    return diag.real / n**2


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris taper (periodic/sym per scipy default: sym=True),
    matching ``scipy.signal.windows.blackmanharris`` used by the reference
    (utils.py:72)."""
    a = (0.35875, 0.48829, 0.14128, 0.01168)
    if n == 1:
        return np.ones(1)
    x = np.arange(n) * (2.0 * np.pi / (n - 1))
    return (
        a[0]
        - a[1] * np.cos(x)
        + a[2] * np.cos(2 * x)
        - a[3] * np.cos(3 * x)
    )


@partial(jax.jit, static_argnames=("subtract_mean", "taper"))
def naive_pspec(
    data: jax.Array, subtract_mean: bool = True, taper: bool = True
) -> jax.Array:
    """Naive (tapered) power spectrum ``fftshift(|fft(d)|^2)`` of 1D or
    ``(Ntimes, Nfreqs)`` data (reference: utils.py:44-74)."""
    nfreqs = data.shape[-1]
    d = data
    if subtract_mean:
        d = d - jnp.mean(d, axis=-1, keepdims=True)
    if taper:
        d = d * jnp.asarray(blackman_harris(nfreqs), dtype=d.dtype)
    return jnp.fft.fftshift(jnp.abs(jnp.fft.fft(d, axis=-1)) ** 2, axes=-1)


def delay_array(nfreqs: int, dfreq_hz: float) -> np.ndarray:
    """fftshifted delay values in nanoseconds for channel width ``dfreq_hz``
    (cf. test_data/plot-test-data-results.py:63)."""
    return np.fft.fftshift(np.fft.fftfreq(nfreqs, d=dfreq_hz * 1e-9))
