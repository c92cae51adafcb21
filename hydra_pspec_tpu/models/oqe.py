"""Optimal Quadratic Estimator (OQE) for the delay power spectrum.

Reference (hydra_pspec/oqe.py): delay-mode quadratic estimator built from
rank-1 operators ``Q(tau) = conj(m) m^T`` with ``m = fft(delta_tau)``
(oqe.py:7-20, disk-cached outer products), estimator values
``qhat = 0.5 x^H R^bar Q R x - bias`` (oqe.py:27-40), a Fisher matrix of
O(s^2) traces (oqe.py:43-66), normalizations (oqe.py:69-84) and error bars
(oqe.py:161-185). As shipped the reference's ``Q`` cache, ``getqs`` and
``M_Fhalf`` raise ``NameError`` (missing ``os``/``time``/``sp`` imports) —
rebuilt here working by construction.

Identities used (no Q matrices are ever materialized; everything is
an FFT because ``m_tau[k] = exp(-2 pi i k tau / s)`` is a DFT row):

  * ``x^H Rbar Q_t R x  = conj(fft(R^T x)[t]) * fft(R x)[t]``
  * ``(Rx1)^H Q_t (Rx2) = conj(fft(R x1)[t]) * fft(R x2)[t]``
  * ``tr(A Q_t)`` terms reduce to diagonals of the 2D transform
    ``F A F^H`` — two FFT passes over a matrix.
  * Fisher: ``F[a,b] = 0.5 * G1[a,b] * G2[b,a]`` with
    ``G1 = dft2(R)``, ``G2 = dft2(conj(R))``.
"""
import jax
import jax.numpy as jnp
import numpy as np

from ..ops import cplx
from ..ops.cplx import C
from ..ops.linalg import hermitian_sqrt


def m(tau, s):
    """DFT row ``m_tau = fft(delta_tau)`` (reference oqe.py:7-10)."""
    k = jnp.arange(s)
    return jnp.exp(-2.0j * jnp.pi * k * tau / s)


def Q(tau, s):
    """Rank-1 delay operator ``outer(conj(m), m)`` (reference oqe.py:13-20;
    no disk cache needed — it is two lines of math)."""
    mt = m(tau, s)
    return jnp.outer(mt.conj(), mt)


def _dft2(a):
    """``G[t, u] = sum_jk exp(-2pi i t j / s) a[j, k] exp(+2pi i u k / s)``
    = F a F^H for the unnormalized DFT matrix F."""
    s = a.shape[-1]
    return jnp.fft.ifft(jnp.fft.fft(a, axis=-2), axis=-1) * s


def _diag_dft2(a):
    """Diagonal of ``F a F^H``: the length-s vector ``m_t^T a conj(m_t)``."""
    return jnp.diagonal(_dft2(a), axis1=-2, axis2=-1)


@jax.jit
def bias(R, C_noise_total):
    """All-tau bias vector ``0.5 tr(C R^bar Q_t R)`` (reference oqe.py:23-24
    computes one tau at a time)."""
    return 0.5 * _diag_dft2(R @ C_noise_total @ R.conj())


@jax.jit
def qhat_all(x, R, bias_vec=None):
    """``0.5 x^H (Rbar Q_t R) x - bias`` for every tau at once (reference
    oqe.py:27-30 per tau). ``x``: (..., s)."""
    rx = jnp.fft.fft(x @ R.T, axis=-1)
    rtx = jnp.fft.fft(x @ R, axis=-1)
    q = 0.5 * rtx.conj() * rx
    if bias_vec is not None:
        q = q - bias_vec
    return q


@jax.jit
def qhat_h_all(x1, x2, R):
    """HERA-style cross-correlation ``0.5 (R x1)^H Q_t (R x2)`` for every
    tau (reference oqe.py:33-40 per tau). Inputs (..., s)."""
    f1 = jnp.fft.fft(x1 @ R.T, axis=-1)
    f2 = jnp.fft.fft(x2 @ R.T, axis=-1)
    return 0.5 * f1.conj() * f2


def qhat(x, tau, s, R, bias_scalar=0.0):
    """Single-tau mirror of reference oqe.py:27-30."""
    return qhat_all(x, R)[..., tau] - bias_scalar


def qhat_h(x1, x2, tau, s, R):
    """Single-tau mirror of reference oqe.py:33-40."""
    return qhat_h_all(x1, x2, R)[..., tau]


@jax.jit
def F(R):
    """Fisher matrix ``F[a,b] = 0.5 tr(Rbar Q_a R Q_b)`` (reference
    oqe.py:43-50 / the einsum-cached Ft at oqe.py:53-66) as two 2D DFTs."""
    g1 = _dft2(R)
    g2 = _dft2(R.conj())
    return 0.5 * g1 * g2.T


Ft = F  # reference keeps a cached variant; identical result


def M_Finv(Fm):
    """Normalization ``M = F^{-1}`` (reference oqe.py:73-74)."""
    return jnp.linalg.inv(Fm)


def M_Fhalf(Fm):
    """``M = F^{-1/2}`` via the Hermitian square root (reference
    oqe.py:69-70 is broken as shipped — missing ``sp`` import)."""
    return jnp.linalg.inv(hermitian_sqrt(0.5 * (Fm + Fm.conj().T)))


@jax.jit
def M_opt(Fm):
    """Window-normalized diagonal M (reference oqe.py:77-84)."""
    Md = jnp.diag(1.0 / jnp.diagonal(Fm))
    W = Md @ Fm
    return Md / jnp.sum(W, axis=1, keepdims=True)


def p(q, M):
    """Normalized bandpowers (reference oqe.py:117-118)."""
    return M @ q


def q(V, s, R, bias_vec):
    """Batched auto-correlation estimator over visibilities (reference
    oqe.py:88-101; the reference assigns complex values into a real array,
    silently discarding the imaginary part — we keep the real part
    explicitly)."""
    return qhat_all(jnp.asarray(V), R, jnp.asarray(bias_vec)).real


def q_h(V, s, R, taper=None):
    """Cross-correlation estimator over adjacent visibility pairs
    (reference oqe.py:104-114)."""
    V = jnp.asarray(V)
    return qhat_h_all(V[0::2], V[1::2], R)


def q_hp(V, s, R, ncpu=None):
    """Reference's multiprocessing variant (oqe.py:147-158) — the batched
    FFT form needs no process pool; ``ncpu`` accepted for API parity."""
    return q_h(V, s, R)


def matc(M):
    """Condition-number diagnostics (reference oqe.py:121-127). Returns
    (is_positive_definite, eigval_ratio, norm_condition) instead of
    printing."""
    evs = jnp.linalg.eigvals(M).real
    Minv = jnp.linalg.inv(M)
    return (
        bool(jnp.all(evs > 0)),
        float(jnp.max(evs) / jnp.min(evs)),
        float(jnp.linalg.norm(M) * jnp.linalg.norm(Minv)),
    )


def getqs(Vis, R, verbose=False):
    """End-to-end skeleton OQE (reference oqe.py:130-144, broken as shipped
    via missing ``time`` import): condition diagnostics, Fisher matrix,
    normalizations, and pair cross-correlation q's."""
    Vis = jnp.asarray(Vis)
    s = Vis.shape[-1]
    if verbose:
        pd, ratio, cond = matc(R)
        print(f"{pd} - positive definite; eig ratio {ratio:.3e}; cond {cond:.3f}")
    Fm = F(R)
    MB = M_opt(Fm)
    MA = M_Finv(Fm)
    qs = q_h(Vis, s, R)
    return qs, Fm, MB, MA


# --- real-pair tier (no complex dtypes: float32 real arithmetic only; ---
# --- pinned against the x64 complex tier in tests) -----------------------

def _dft_mat_rp(s: int, dtype=jnp.float32) -> C:
    """Unnormalized DFT operator ``F[t, k] = exp(-2 pi i t k / s)`` as a
    real pair (symmetric, so row transforms are ``x @ F``)."""
    k = np.arange(s)
    ph = np.outer(k, k) * (-2.0 * np.pi / s)
    return C(jnp.asarray(np.cos(ph), dtype=dtype),
             jnp.asarray(np.sin(ph), dtype=dtype))


def _dft_rows_rp(x: C, f: C) -> C:
    """fft along the last axis as a matmul (s ~ 10^2: MXU beats FFT and
    avoids complex dtypes entirely)."""
    return cplx.matmul(x, f)


def _dft2_rp(a: C, f: C) -> C:
    """``F a F^H`` — real-pair twin of :func:`_dft2`."""
    return cplx.matmul(cplx.matmul(f, a), f.adjoint())


def _diag_rp(a: C) -> C:
    return C(jnp.diagonal(a.re, axis1=-2, axis2=-1),
             jnp.diagonal(a.im, axis1=-2, axis2=-1))


@jax.jit
def bias_rp(R: C, C_noise_total: C) -> C:
    """Real-pair twin of :func:`bias`."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    return 0.5 * _diag_rp(_dft2_rp(
        cplx.matmul(cplx.matmul(R, C_noise_total), R.conj()), f))


@jax.jit
def qhat_all_rp(x: C, R: C, bias_vec: C = None) -> C:
    """Real-pair twin of :func:`qhat_all`; ``x``: (..., s) pair."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    rx = _dft_rows_rp(cplx.matmul(x, R.T), f)
    rtx = _dft_rows_rp(cplx.matmul(x, R), f)
    q = 0.5 * (rtx.conj() * rx)
    if bias_vec is not None:
        q = q - bias_vec
    return q


@jax.jit
def qhat_h_all_rp(x1: C, x2: C, R: C) -> C:
    """Real-pair twin of :func:`qhat_h_all`."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    f1 = _dft_rows_rp(cplx.matmul(x1, R.T), f)
    f2 = _dft_rows_rp(cplx.matmul(x2, R.T), f)
    return 0.5 * (f1.conj() * f2)


@jax.jit
def F_rp(R: C) -> C:
    """Real-pair Fisher matrix (twin of :func:`F`)."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    g1 = _dft2_rp(R, f)
    g2 = _dft2_rp(R.conj(), f)
    return 0.5 * (g1 * g2.T)


def _inv_general_rp(a: C) -> C:
    """Inverse of a general complex matrix via its real 2n x 2n embedding
    (the inverse of [[Ar, -Ai], [Ai, Ar]] keeps the same structure)."""
    e = cplx.embed_hermitian(a)  # structure embedding; no Hermitian claim
    x = jnp.linalg.inv(e)
    h = a.re.shape[-1]
    return C(x[..., :h, :h], x[..., h:, :h])


def M_Finv_rp(Fm: C) -> C:
    """Real-pair ``M = F^{-1}``."""
    return _inv_general_rp(Fm)


def hermitian_sqrt_rp(m: C) -> C:
    """Hermitian PSD square root via eigh of the real embedding
    (sqrt(E) is the embedding of sqrt(M))."""
    e = cplx.embed_hermitian(m)
    vals, vecs = jnp.linalg.eigh(e)
    se = (vecs * jnp.sqrt(jnp.clip(vals, 0.0, None))) @ vecs.T
    h = m.re.shape[-1]
    return C(se[..., :h, :h], se[..., h:, :h])


def M_Fhalf_rp(Fm: C) -> C:
    """Real-pair ``M = F^{-1/2}`` (Hermitian part)."""
    herm = C(0.5 * (Fm.re + Fm.re.T), 0.5 * (Fm.im - Fm.im.T))
    return _inv_general_rp(hermitian_sqrt_rp(herm))


@jax.jit
def M_opt_rp(Fm: C) -> C:
    """Real-pair window-normalized diagonal M (twin of :func:`M_opt`)."""
    d = _diag_rp(Fm)
    dinv = cplx.cdiv(C(jnp.ones_like(d.re), jnp.zeros_like(d.im)), d)
    # Md @ Fm scales rows of Fm by dinv
    W = C(dinv.re[:, None] * Fm.re - dinv.im[:, None] * Fm.im,
          dinv.re[:, None] * Fm.im + dinv.im[:, None] * Fm.re)
    rs = C(jnp.sum(W.re, axis=1), jnp.sum(W.im, axis=1))
    md = cplx.cdiv(dinv, rs)
    n = Fm.re.shape[-1]
    eye = jnp.eye(n, dtype=Fm.re.dtype)
    return C(eye * md.re[:, None], eye * md.im[:, None])


def q_h_rp(V: C, s, R: C):
    """Real-pair cross-correlation estimator over adjacent pairs."""
    v1 = C(V.re[0::2], V.im[0::2])
    v2 = C(V.re[1::2], V.im[1::2])
    return qhat_h_all_rp(v1, v2, R)


def getqs_rp(Vis: C, R: C):
    """Real-pair end-to-end OQE (twin of :func:`getqs`)."""
    s = Vis.re.shape[-1]
    Fm = F_rp(R)
    MB = M_opt_rp(Fm)
    MA = M_Finv_rp(Fm)
    qs = q_h_rp(Vis, s, R)
    return qs, Fm, MB, MA


@jax.jit
def Sig_QEN_rp(R: C, C_noise: C, norm) -> C:
    """Real-pair noise-only error bar (twin of :func:`Sig_QEN`)."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    t = _diag_rp(_dft2_rp(cplx.matmul(cplx.matmul(R, C_noise), R), f))
    norm = jnp.asarray(norm, dtype=R.re.dtype)
    nt = C(norm * t.re, norm * t.im)
    return 0.5 * (nt * nt)


@jax.jit
def Sig_QESN_rp(R: C, C_noise: C, C_S: C, norm) -> C:
    """Real-pair signal+noise error bar (twin of :func:`Sig_QESN`)."""
    f = _dft_mat_rp(R.re.shape[-1], R.re.dtype)
    tn = _diag_rp(_dft2_rp(cplx.matmul(cplx.matmul(R, C_noise), R), f))
    ts = _diag_rp(_dft2_rp(cplx.matmul(cplx.matmul(R, C_S), R), f))
    norm = jnp.asarray(norm, dtype=R.re.dtype)
    return 0.5 * (norm * norm) * ((tn * tn) + 2.0 * (ts * tn))


@jax.jit
def Sig_QEN(R, C_noise, norm):
    """Noise-only error bar ``0.5 tr(E C E C)`` with ``E = R Q_t R * norm``
    (reference oqe.py:161-173). ``norm`` scalar or per-tau vector. Uses
    ``tr(u v^T C u v^T C) = (v^T C u)^2`` with the rank-1 structure of E."""
    t = _diag_dft2(R @ C_noise @ R)
    norm = jnp.asarray(norm)
    return 0.5 * (norm * t) ** 2 * jnp.ones_like(t)


@jax.jit
def Sig_QESN(R, C_noise, C_S, norm):
    """Signal+noise error bar (reference oqe.py:177-185)."""
    tn = _diag_dft2(R @ C_noise @ R)
    ts = _diag_dft2(R @ C_S @ R)
    norm = jnp.asarray(norm)
    return 0.5 * norm**2 * (tn * tn + 2.0 * ts * tn)
