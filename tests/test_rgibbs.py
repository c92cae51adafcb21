"""Real-pair engine tests: exact agreement with the complex engine at
float64, the real-pair primitive layer against numpy complex, the XLA
solvers at the engine's widths, and full-precision products."""
import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from hydra_pspec_tpu.models import gcr, gibbs, rgibbs
from hydra_pspec_tpu.ops import cplx

RNG = np.random.default_rng(31)


def crandn(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


class TestCplxPrimitives:
    def test_matmul_gauss(self):
        a, b = crandn(9, 7), crandn(7, 5)
        out = cplx.to_numpy(
            cplx.matmul(cplx.from_numpy(a, jnp.float64), cplx.from_numpy(b, jnp.float64))
        )
        np.testing.assert_allclose(out, a @ b, atol=1e-12)

    def test_elementwise_and_adjoint(self):
        a, b = crandn(4, 6), crandn(4, 6)
        ca, cb = cplx.from_numpy(a, jnp.float64), cplx.from_numpy(b, jnp.float64)
        np.testing.assert_allclose(cplx.to_numpy(ca * cb), a * b, atol=1e-12)
        np.testing.assert_allclose(cplx.to_numpy(ca + cb), a + b, atol=1e-12)
        np.testing.assert_allclose(cplx.to_numpy(ca.conj()), a.conj(), atol=0)
        np.testing.assert_allclose(cplx.to_numpy(ca.adjoint()), a.conj().T, atol=0)
        np.testing.assert_allclose(np.asarray(ca.abs2()), np.abs(a) ** 2, atol=1e-12)

    def test_dft_matrix_matches_fourier_operator(self):
        from hydra_pspec_tpu.ops.fourier import fourier_operator

        for n in (8, 120):
            f = cplx.dft_matrix(n, jnp.float64)
            np.testing.assert_allclose(
                cplx.to_numpy(f), np.asarray(fourier_operator(n)), atol=1e-10
            )

    def test_cfft_rows(self):
        from hydra_pspec_tpu.ops.fourier import cfft

        x = crandn(5, 16)
        f = cplx.dft_matrix(16, jnp.float64)
        out = cplx.to_numpy(cplx.cfft_rows(cplx.from_numpy(x, jnp.float64), f))
        np.testing.assert_allclose(out, np.asarray(cfft(jnp.asarray(x))), atol=1e-10)

    def test_hermitian_solve(self):
        n, k = 12, 7
        X = crandn(n, n)
        m = X @ X.conj().T + np.eye(n)
        b = crandn(n, k)
        x = cplx.to_numpy(
            cplx.hermitian_solve(
                cplx.from_numpy(m, jnp.float64), cplx.from_numpy(b, jnp.float64)
            )
        )
        np.testing.assert_allclose(m @ x, b, atol=1e-10)

    def test_standard_normal_stats(self):
        z = cplx.standard_normal(jax.random.key(0), (20000,))
        zr, zi = np.asarray(z.re), np.asarray(z.im)
        assert abs(zr.var() - 0.5) < 0.02
        assert abs(zi.var() - 0.5) < 0.02
        assert abs(zr.mean()) < 0.02


def to_delay(oa):
    """Transform a freq-basis omega_a draw to the engine's delay-basis
    convention (rows per time: F @ oa_t  ==  oa @ F, F symmetric)."""
    from hydra_pspec_tpu.ops.fourier import fourier_operator
    F = np.asarray(fourier_operator(oa.shape[-1], dtype=jnp.complex128))
    return oa @ F


def make_problem(ntimes=17, nfreqs=24, nmodes=4):
    d = crandn(ntimes, nfreqs) * 2.0
    w = np.ones(nfreqs); w[3] = 0; w[11] = 0
    fg = crandn(nfreqs, nmodes)
    ninv = np.abs(RNG.standard_normal(nfreqs)) + 1.0
    ps = np.abs(RNG.standard_normal(nfreqs)) * 10.0 + 0.05
    prior = np.zeros((2, nfreqs))
    return d, w, fg, ninv, ps, prior


class TestEngineAgreement:
    def test_gcr_solve_matches_complex_engine(self):
        d, w, fg, ninv, ps, _ = make_problem()
        ntimes, nfreqs = d.shape
        oa, ob = crandn(ntimes, nfreqs), crandn(ntimes, nfreqs)

        cops = gcr.build_chain_operators(d, w, fg, ninv)
        cres = gcr.gcr_solve(cops, jnp.asarray(ps), jnp.asarray(oa), jnp.asarray(ob))

        rops = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float64)
        sig, amps, sk = rgibbs.gcr_solve(
            rops, jnp.asarray(ps)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float64),
            cplx.from_numpy(ob[None], jnp.float64),
        )
        np.testing.assert_allclose(
            cplx.to_numpy(sig)[0], np.asarray(cres.signal_cr), atol=1e-9
        )
        np.testing.assert_allclose(
            cplx.to_numpy(amps)[0], np.asarray(cres.fg_amps), atol=1e-9
        )

    def test_map_step_matches(self):
        d, w, fg, ninv, ps, prior = make_problem()
        cops = gcr.build_chain_operators(d, w, fg, ninv)
        _, cs = gibbs.gibbs_step(
            jax.random.key(0), jnp.asarray(ps), cops, jnp.asarray(prior),
            map_estimate=True,
        )
        rops = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float64)
        _, rs = rgibbs.gibbs_step(
            jax.random.key(0), jnp.asarray(ps)[None], rops, jnp.asarray(prior),
            map_estimate=True,
        )
        np.testing.assert_allclose(
            cplx.to_numpy(rs.signal_cr)[0], np.asarray(cs.signal_cr), atol=1e-9
        )
        np.testing.assert_allclose(
            np.asarray(rs.chisq)[0], np.asarray(cs.chisq), atol=1e-9
        )

    def test_f32_engine_close_to_f64(self):
        """The production float32 path must track float64 to ~1e-4 relative
        on a well-conditioned problem (roundoff, not algorithm error)."""
        d, w, fg, ninv, ps, _ = make_problem()
        ntimes, nfreqs = d.shape
        oa, ob = crandn(ntimes, nfreqs), crandn(ntimes, nfreqs)
        r64 = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float64)
        r32 = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float32)
        s64, _, _ = rgibbs.gcr_solve(
            r64, jnp.asarray(ps)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float64),
            cplx.from_numpy(ob[None], jnp.float64),
        )
        s32, _, _ = rgibbs.gcr_solve(
            r32, jnp.asarray(ps, dtype=jnp.float32)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float32),
            cplx.from_numpy(ob[None], jnp.float32),
        )
        ref = cplx.to_numpy(s64)
        err = np.abs(cplx.to_numpy(s32) - ref) / (np.abs(ref).mean())
        assert err.max() < 1e-3, err.max()

    def test_chain_runs_and_is_consistent(self):
        """Distributional sanity of the full real-engine chain: chisq ~ 1
        on self-consistent synthetic data."""
        ntimes, nfreqs = 64, 16
        sig = crandn(ntimes, nfreqs) * 2.0
        noise = crandn(ntimes, nfreqs) * 0.5
        d = sig + noise
        w = np.ones(nfreqs)
        fg = np.zeros((nfreqs, 1), dtype=complex); fg[:, 0] = 1 / np.sqrt(nfreqs)
        ninv = np.full(nfreqs, 1 / 0.25)
        prior = np.zeros((2, nfreqs))
        rops = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float64)
        ps0 = jnp.full((1, nfreqs), 4.0 * nfreqs)
        ps, samples = rgibbs.run_chain_jit(
            jax.random.key(1), rops, ps0, jnp.asarray(prior), 100, store_cr=False
        )
        chi = np.asarray(samples.chisq)
        assert np.isfinite(chi).all()
        assert abs(chi[50:].mean() - 1.0) < 0.1, chi[50:].mean()

    def test_dense_ninv_matches_complex_engine(self):
        """Real-engine twin of test_gcr_matches_reference_system[True]:
        genuinely dense Hermitian Ninv through the real-pair path must
        reproduce the complex engine (itself pinned against the reference
        block system) exactly at float64."""
        d, w, fg, _, ps, _ = make_problem()
        ntimes, nfreqs = d.shape
        X = crandn(nfreqs, nfreqs)
        dense = X @ X.conj().T + 3.0 * np.eye(nfreqs)
        oa, ob = crandn(ntimes, nfreqs), crandn(ntimes, nfreqs)

        cops = gcr.build_chain_operators(d, w, fg, dense)
        cres = gcr.gcr_solve(cops, jnp.asarray(ps), jnp.asarray(oa),
                             jnp.asarray(ob))

        rops = rgibbs.build_chain_operators(d, w, fg, dense, dtype=jnp.float64)
        assert rops.ni_dense is not None and rops.nih_dense is not None
        sig, amps, _ = rgibbs.gcr_solve(
            rops, jnp.asarray(ps)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float64),
            cplx.from_numpy(ob[None], jnp.float64),
        )
        np.testing.assert_allclose(
            cplx.to_numpy(sig)[0], np.asarray(cres.signal_cr), atol=1e-8
        )
        np.testing.assert_allclose(
            cplx.to_numpy(amps)[0], np.asarray(cres.fg_amps), atol=1e-8
        )

        # full step: chisq + ln_post diagnostics under dense noise
        _, cs = gibbs.gibbs_step(
            jax.random.key(0), jnp.asarray(ps), cops,
            jnp.zeros((2, nfreqs)), map_estimate=True,
        )
        _, rs = rgibbs.gibbs_step(
            jax.random.key(0), jnp.asarray(ps)[None], rops,
            jnp.zeros((2, nfreqs)), map_estimate=True,
        )
        np.testing.assert_allclose(
            np.asarray(rs.chisq)[0], np.asarray(cs.chisq), atol=1e-8
        )


class TestRecursiveInverse:
    def test_hermitian_inverse_matches_numpy(self):
        for n in (7, 33, 132):
            X = crandn(n, n)
            m = X @ X.conj().T + np.eye(n)
            minv = cplx.to_numpy(
                cplx.hermitian_inverse(cplx.from_numpy(m, jnp.float64))
            )
            np.testing.assert_allclose(minv, np.linalg.inv(m), atol=1e-8)

    def test_recinv_solve_matches_chol_solve(self):
        n, k = 40, 9
        X = crandn(n, n)
        m = X @ X.conj().T + np.eye(n)
        b = crandn(n, k)
        mc = cplx.from_numpy(m, jnp.float64)
        bc = cplx.from_numpy(b, jnp.float64)
        x1 = cplx.to_numpy(cplx.hermitian_solve(mc, bc))
        x2 = cplx.to_numpy(cplx.hermitian_solve_recinv(mc, bc))
        np.testing.assert_allclose(x1, x2, atol=1e-9)

    def test_recinv_f32_real_problem_accuracy(self):
        """f32 recinv on the ill-scaled GCR matrix must stay within solver
        tolerance of f64 (the deflation + Jacobi + refinement stack)."""
        d, w, fg, ninv, ps, _ = make_problem(ntimes=11, nfreqs=32, nmodes=5)
        oa, ob = crandn(11, 32), crandn(11, 32)
        r64 = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float64)
        r32 = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float32)
        s64, _, _ = rgibbs.gcr_solve(
            r64, jnp.asarray(ps)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float64),
            cplx.from_numpy(ob[None], jnp.float64),
        )
        s32, _, _ = rgibbs.gcr_solve(
            r32, jnp.asarray(ps, dtype=jnp.float32)[None],
            cplx.from_numpy(to_delay(oa)[None], jnp.float32),
            cplx.from_numpy(ob[None], jnp.float32),
        )
        ref_ = cplx.to_numpy(s64)
        err = np.abs(cplx.to_numpy(s32) - ref_).max() / np.abs(ref_).mean()
        assert err < 1e-3, err


def _gcr_like_system(n, rng):
    """An HPD matrix shaped like the engine's system I + D P D: bandpower
    scaling D over ~4 decades and a dense HPD noise term."""
    x = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    p = x @ x.conj().T / n
    d = np.sqrt(np.logspace(-2, 2, n))
    return np.eye(n) + d[:, None] * p * d[None, :]


@pytest.mark.parametrize("solver", ["chol", "recinv"])
@pytest.mark.parametrize("n", [16, 120, 128])     # embedded 32 / 240 / 256
@pytest.mark.parametrize("k", [1, 203])
def test_xla_solvers_match_numpy(solver, n, k):
    """Both XLA Hermitian solves against numpy complex128: exact to
    roundoff at float64, and within 1e-4 (norm-wise) at float32."""
    rng = np.random.default_rng(n * 1000 + k)
    m = _gcr_like_system(n, rng)
    b = rng.standard_normal((n, k)) + 1j * rng.standard_normal((n, k))
    want = np.linalg.solve(m, b)
    solve = {"chol": cplx.hermitian_solve,
             "recinv": cplx.hermitian_solve_recinv}[solver]
    for dtype, tol in ((jnp.float64, 1e-9), (jnp.float32, 1e-4)):
        got = cplx.to_numpy(solve(cplx.from_numpy(m, dtype),
                                  cplx.from_numpy(b, dtype)))
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < tol, (dtype, err)


def _dot_precisions(jaxpr):
    """Precision configs of every dot_general in a jaxpr, sub-jaxprs
    (scan, cond, pjit, custom rules) included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


@pytest.mark.parametrize("solver", ["chol", "recinv"])
@pytest.mark.parametrize("flagged", [False, True])
def test_every_product_is_full_precision(solver, flagged):
    """No dot_general of the Gibbs step runs at default precision — on a
    GPU that is TF32, ~1e-3 per product, which the solve amplifies."""
    d, w, fg, ninv, ps, prior = make_problem()
    if not flagged:
        w = np.ones_like(w)
    ops = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=jnp.float32)
    closed = jax.make_jaxpr(
        lambda k, p: rgibbs.gibbs_step(
            k, p, ops, jnp.asarray(prior, jnp.float32), solver=solver,
            all_unflagged=not flagged)
    )(jax.random.key(0), jnp.asarray(ps, jnp.float32)[None])
    precisions = _dot_precisions(closed.jaxpr)
    assert len(precisions) >= 10
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in precisions), precisions


def test_chi_unbiased_with_bright_foregrounds():
    """With foreground amplitudes ~1e3 x the noise scale, a float32
    product of Fg @ amps inside the residual would plant a deterministic
    error ~1e-5 |FG| into the noise-scale residual (chi^2 off by ~0.5%).
    The engine FG-deflates (d - Fg a0 host-side in float64, matmuls on the
    amplitude deviation only): its float32 mean chi^2 must match float64
    to well under that bias, given identical fluctuation draws."""
    ntimes, nfreqs, nmodes = 24, 16, 3
    fg = np.linalg.qr(crandn(nfreqs, nmodes))[0]
    amps_true = crandn(ntimes, nmodes) * 3e3
    d = amps_true @ fg.T + crandn(ntimes, nfreqs) * 2.0 \
        + crandn(ntimes, nfreqs)
    w = np.ones(nfreqs)
    ninv = np.ones(nfreqs)
    ps = np.abs(RNG.standard_normal(nfreqs)) * 4.0 + 0.1
    oa = to_delay(crandn(ntimes, nfreqs))[None]
    ob = crandn(1, ntimes, nfreqs)

    def mean_chi(dtype):
        ops = rgibbs.build_chain_operators(d, w, fg, ninv, dtype=dtype)
        sig, amps, _ = rgibbs.gcr_solve(
            ops, jnp.asarray(ps, dtype)[None], cplx.from_numpy(oa, dtype),
            cplx.from_numpy(ob, dtype), solver="chol")
        resid = ops.d_w - (sig + cplx.matmul(amps, rgibbs._t(ops.fg)))
        return float(jnp.mean(resid.abs2() * ops.ninv_full_diag[:, None, :]))

    ref_chi = mean_chi(jnp.float64)
    assert abs(mean_chi(jnp.float32) - ref_chi) / ref_chi < 5e-4
