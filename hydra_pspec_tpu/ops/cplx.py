"""Real-pair complex arithmetic — the real engine's execution layer.

A complex array is carried as a ``C(re, im)`` pair of real arrays, so the
real engine (models/rgibbs.py) runs every product as a real matmul at an
explicitly chosen precision:

  * complex matmul uses the 3-multiplication Gauss/Karatsuba form
    (25% fewer real matmul FLOPs than the naive 4-matmul form);
  * a Hermitian positive-definite solve uses the real symmetric embedding
    ``E = [[Mr, -Mi], [Mi, Mr]]`` (SPD iff M is HPD), so XLA's batched
    float32 Cholesky/triangular-solve path does the work;
  * the centered DFT is a (tiny-n) matmul against a precomputed real-pair
    DFT matrix.

Everything here is dtype-generic and runs identically on CPU (where the
tests pin it against numpy complex arithmetic at float64).
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Full float32 products. The default precision of an f32 matmul on a GPU
# is TF32 (~1e-3 relative error per product — enough to break the
# Gauss-trick cancellation and, amplified by the solve, the GCR draw), so
# every product here asks for HIGHEST explicitly.
PRECISION = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=PRECISION)


class C(NamedTuple):
    """A complex tensor as a (re, im) pair of real tensors."""

    re: jax.Array
    im: jax.Array

    @property
    def shape(self):
        return self.re.shape

    @property
    def dtype(self):
        return self.re.dtype

    def conj(self):
        return C(self.re, -self.im)

    @property
    def T(self):
        return C(self.re.T, self.im.T)

    def adjoint(self):
        return C(
            jnp.swapaxes(self.re, -1, -2), -jnp.swapaxes(self.im, -1, -2)
        )

    def __add__(self, other):
        if isinstance(other, C):
            return C(self.re + other.re, self.im + other.im)
        return C(self.re + other, self.im)

    def __sub__(self, other):
        if isinstance(other, C):
            return C(self.re - other.re, self.im - other.im)
        return C(self.re - other, self.im)

    def __mul__(self, other):
        """Elementwise product; ``other`` may be C or real."""
        if isinstance(other, C):
            return C(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return C(self.re * other, self.im * other)

    __rmul__ = __mul__

    def abs2(self):
        """|z|^2 (real array)."""
        return self.re * self.re + self.im * self.im


def cdiv(a: C, b: C) -> C:
    """Elementwise complex division a / b."""
    d = jnp.maximum(b.abs2(), jnp.finfo(b.re.dtype).tiny)
    return C((a.re * b.re + a.im * b.im) / d,
             (a.im * b.re - a.re * b.im) / d)


def from_numpy(z, dtype=jnp.float32) -> C:
    z = np.asarray(z)
    return C(jnp.asarray(z.real, dtype=dtype), jnp.asarray(z.imag, dtype=dtype))


def to_numpy(z: C) -> np.ndarray:
    return np.asarray(z.re) + 1j * np.asarray(z.im)


def matmul(a: C, b: C) -> C:
    """Complex matmul with 3 real matmuls (Gauss):
    re = P1 - P2, im = P3 - P1 - P2 where
    P1 = ar br, P2 = ai bi, P3 = (ar + ai)(br + bi)."""
    p1 = _mm(a.re, b.re)
    p2 = _mm(a.im, b.im)
    p3 = _mm(a.re + a.im, b.re + b.im)
    return C(p1 - p2, p3 - p1 - p2)


def matmul_rc(a, b: C) -> C:
    """real @ complex."""
    return C(_mm(a, b.re), _mm(a, b.im))


def matmul_cr(a: C, b) -> C:
    """complex @ real."""
    return C(_mm(a.re, b), _mm(a.im, b))


def dft_matrix(n: int, dtype=jnp.float32) -> C:
    """Centered DFT operator (utils.py:15-41 semantics) as a real pair."""
    i = np.arange(n) - n // 2
    ph = np.outer(i, i) * (-2.0 * np.pi / n)
    return C(jnp.asarray(np.cos(ph), dtype=dtype), jnp.asarray(np.sin(ph), dtype=dtype))


def cfft_rows(x: C, f: C) -> C:
    """Centered DFT of each row of ``x``: rows are length-n vectors,
    result ``x @ F^T``; F is symmetric so ``x @ F``."""
    return matmul(x, f)


def embed_hermitian(m: C) -> jax.Array:
    """Real symmetric embedding of a Hermitian matrix:
    ``E = [[Mr, -Mi], [Mi, Mr]]`` (2n x 2n), SPD iff M is HPD."""
    top = jnp.concatenate([m.re, -m.im], axis=-1)
    bot = jnp.concatenate([m.im, m.re], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def embed_rhs(b: C) -> jax.Array:
    """(n, k) complex RHS -> (2n, k) real RHS [Br; Bi]."""
    return jnp.concatenate([b.re, b.im], axis=-2)


def unembed_solution(x: jax.Array) -> C:
    n2 = x.shape[-2]
    n = n2 // 2
    return C(x[..., :n, :], x[..., n:, :])


def _inv_1x1(m: C) -> C:
    d = jnp.maximum(m.re * m.re + m.im * m.im, jnp.finfo(m.re.dtype).tiny)
    return C(m.re / d, -m.im / d)


def _inv_embedded(m: C) -> C:
    """Base-case Hermitian inverse via XLA ``inv`` on the real symmetric
    embedding (the inverse of [[Mr,-Mi],[Mi,Mr]] has the same structure)."""
    e = embed_hermitian(m)
    xe = jnp.linalg.inv(e)
    h = m.shape[-1]
    return C(xe[..., :h, :h], xe[..., h:, :h])


def hermitian_inverse(m: C, base: int = 36) -> C:
    """Inverse of a Hermitian positive-definite matrix by fully-unrolled
    2x2 block Schur recursion — matmuls only, no factorization loops.

    The recursion unrolls to ~6 ops per level x log2(n) levels of
    *batched* matmuls, where a factorization is a loop of O(n/block)
    sequential steps. Accuracy is the usual explicit-inverse cond(M)*eps —
    fine after Jacobi equilibration (callers scale first).

        M = [[A, B], [B^H, C]],  S = C - B^H A^{-1} B  (Schur complement)
        M^{-1} = [[A^{-1} + T S^{-1} T^H, -T S^{-1}],
                  [-(T S^{-1})^H,          S^{-1}]],   T = A^{-1} B
    """
    n = m.shape[-1]
    if n == 1:
        return _inv_1x1(m)
    if n <= base:
        return _inv_embedded(m)
    h = n // 2
    A = C(m.re[..., :h, :h], m.im[..., :h, :h])
    Bb = C(m.re[..., :h, h:], m.im[..., :h, h:])
    Cc = C(m.re[..., h:, h:], m.im[..., h:, h:])
    Ainv = hermitian_inverse(A, base)
    T = matmul(Ainv, Bb)
    S = Cc - matmul(Bb.adjoint(), T)
    Sinv = hermitian_inverse(S, base)
    TS = matmul(T, Sinv)
    tl = Ainv + matmul(TS, T.adjoint())
    re = jnp.concatenate(
        [
            jnp.concatenate([tl.re, -TS.re], axis=-1),
            jnp.concatenate([-jnp.swapaxes(TS.re, -1, -2), Sinv.re], axis=-1),
        ],
        axis=-2,
    )
    im = jnp.concatenate(
        [
            jnp.concatenate([tl.im, -TS.im], axis=-1),
            jnp.concatenate([jnp.swapaxes(TS.im, -1, -2), Sinv.im], axis=-1),
        ],
        axis=-2,
    )
    return C(re, im)


def hermitian_solve_recinv(m: C, b: C, jitter: float = 0.0,
                           refine: int = 1) -> C:
    """Solve ``M X = B`` (M Hermitian PD) via the recursive explicit
    inverse + one step of iterative refinement, with Jacobi equilibration.
    Agrees with :func:`hermitian_solve` to solver accuracy (pinned in
    tests)."""
    d = jnp.sqrt(jnp.clip(jnp.diagonal(m.re, axis1=-2, axis2=-1),
                          jnp.finfo(m.re.dtype).tiny, None))
    dinv = 1.0 / d
    scale = dinv[..., :, None] * dinv[..., None, :]
    ms = C(m.re * scale, m.im * scale)
    if jitter:
        n = ms.shape[-1]
        ms = ms + jitter * jnp.eye(n, dtype=ms.dtype)
    bs = C(b.re * dinv[..., :, None], b.im * dinv[..., :, None])
    minv = hermitian_inverse(ms)
    x = matmul(minv, bs)
    for _ in range(refine):
        r = bs - matmul(ms, x)
        x = x + matmul(minv, r)
    return C(x.re * dinv[..., :, None], x.im * dinv[..., :, None])


def hermitian_solve(m: C, b: C, jitter: float = 0.0) -> C:
    """Solve ``M X = B`` for Hermitian positive-definite M via Cholesky of
    the real embedding, with Jacobi pre-scaling (the bandpowers give M a
    huge dynamic range; equilibration keeps f32 Cholesky stable)."""
    e = embed_hermitian(m)
    n2 = e.shape[-1]
    d = jnp.sqrt(jnp.clip(jnp.diagonal(e, axis1=-2, axis2=-1),
                          jnp.finfo(e.dtype).tiny, None))
    dinv = 1.0 / d
    e = e * (dinv[..., :, None] * dinv[..., None, :])
    if jitter:
        e = e + jitter * jnp.eye(n2, dtype=e.dtype)
    rhs = embed_rhs(b) * dinv[..., :, None]
    chol = jnp.linalg.cholesky(e)
    y = jax.scipy.linalg.solve_triangular(chol, rhs, lower=True)
    x = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(chol, -1, -2), y, lower=False
    )
    return unembed_solution(x * dinv[..., :, None])


def block2x2(a: C, b: C, c: C, d: C) -> C:
    """Assemble [[a, b], [c, d]]."""
    return C(
        jnp.block([[a.re, b.re], [c.re, d.re]]),
        jnp.block([[a.im, b.im], [c.im, d.im]]),
    )


def standard_normal(key, shape, dtype=jnp.float32) -> C:
    """Standard *complex* normal: re, im ~ N(0, 1/2)."""
    kr, ki = jax.random.split(key)
    s = np.sqrt(0.5).astype(np.float32)
    return C(
        jax.random.normal(kr, shape, dtype=dtype) * s,
        jax.random.normal(ki, shape, dtype=dtype) * s,
    )
