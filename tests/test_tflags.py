"""Time-dependent flags (per-pattern groups) vs the brute-force per-time
solve — the reference cannot do this at all (run-hydra-pspec.py:541 FIXME
collapses to w_any)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydra_pspec_tpu.models import gcr, gibbs, rgibbs, tflags
from hydra_pspec_tpu.ops import cplx

RNG = np.random.default_rng(91)


def crandn(*shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


def make_problem(ntimes=10, nfreqs=16, nmodes=3):
    d = crandn(ntimes, nfreqs) * 2
    fg = crandn(nfreqs, nmodes)
    ninv = np.abs(RNG.standard_normal(nfreqs)) + 1.0
    ps = np.abs(RNG.standard_normal(nfreqs)) * 3 + 0.5
    # three distinct flag patterns across times (True = flagged)
    flags = np.zeros((ntimes, nfreqs), dtype=bool)
    flags[3:6, 4] = True
    flags[6:, 4] = True
    flags[6:, 10:12] = True
    return d, flags, fg, ninv, ps


def test_group_flag_patterns():
    _, flags, *_ = make_problem()
    groups = tflags.group_flag_patterns(flags)
    assert len(groups) == 3
    idx_all = np.concatenate([g[1] for g in groups])
    assert sorted(idx_all.tolist()) == list(range(10))
    w0, idx0 = groups[0]
    assert np.array_equal(idx0, np.arange(0, 3))
    assert w0.min() == 1.0  # first pattern unflagged
    w2, idx2 = groups[2]
    assert np.array_equal(idx2, np.arange(6, 10))
    assert w2[4] == 0.0 and w2[10] == 0.0 and w2[11] == 0.0


def test_grouped_map_matches_per_time_bruteforce():
    """The grouped MAP solve must equal solving every time sample
    individually with its own flag pattern (exact, x64)."""
    d, flags, fg, ninv, ps = make_problem()
    groups = tflags.build_grouped_operators(d, flags, fg, ninv)
    ps_j = jnp.asarray(ps)
    _, sample = tflags.gibbs_step_tflags(
        jax.random.key(0), ps_j, groups, jnp.zeros((2, d.shape[1])),
        map_estimate=True,
    )
    for t in range(d.shape[0]):
        w_t = (~flags[t]).astype(float)
        ops_t = gcr.build_chain_operators(d[t : t + 1], w_t, fg, ninv)
        res_t = gcr.gcr_solve(ops_t, ps_j, None, None)
        np.testing.assert_allclose(
            np.asarray(sample.signal_cr[t]), np.asarray(res_t.signal_cr[0]),
            rtol=1e-9, atol=1e-11,
        )
        np.testing.assert_allclose(
            np.asarray(sample.fg_amps[t]), np.asarray(res_t.fg_amps[0]),
            rtol=1e-9, atol=1e-11,
        )


def test_single_group_matches_plain_engine_map():
    """All-unflagged data forms one group; its MAP must equal the plain
    (w_any) engine's MAP exactly."""
    d, _, fg, ninv, ps = make_problem()
    flags = np.zeros(d.shape, dtype=bool)
    groups = tflags.build_grouped_operators(d, flags, fg, ninv)
    assert len(groups) == 1
    ps_j = jnp.asarray(ps)
    prior = jnp.zeros((2, d.shape[1]))
    _, s_grp = tflags.gibbs_step_tflags(
        jax.random.key(0), ps_j, groups, prior, map_estimate=True)
    ops = gcr.build_chain_operators(d, np.ones(d.shape[1]), fg, ninv)
    _, s_plain = gibbs.gibbs_step(
        jax.random.key(0), ps_j, ops, prior, map_estimate=True)
    np.testing.assert_allclose(np.asarray(s_grp.signal_cr),
                               np.asarray(s_plain.signal_cr),
                               rtol=1e-10, atol=1e-12)
    # ln_post depends on the drawn ps (different PRNG streams by design);
    # chisq depends only on the shared MAP solution
    np.testing.assert_allclose(np.asarray(s_grp.chisq),
                               np.asarray(s_plain.chisq),
                               rtol=1e-10, atol=1e-12)


def test_real_engine_grouped_matches_complex():
    """Real-pair grouped MAP (f32) tracks the complex grouped MAP (x64)."""
    d, flags, fg, ninv, ps = make_problem()
    groups_c = tflags.build_grouped_operators(d, flags, fg, ninv)
    groups_r = tflags.build_grouped_operators_real(d, flags, fg, ninv)
    ps_j = jnp.asarray(ps)
    prior = jnp.zeros((2, d.shape[1]))
    _, s_c = tflags.gibbs_step_tflags(
        jax.random.key(0), ps_j, groups_c, prior, map_estimate=True)
    ps_r = jnp.asarray(ps, dtype=jnp.float32)[None]
    _, s_r = tflags.gibbs_step_tflags_real(
        jax.random.key(0), ps_r, groups_r, prior.astype(jnp.float32),
        map_estimate=True, solver="chol")
    got = cplx.to_numpy(s_r.signal_cr)[0]
    want = np.asarray(s_c.signal_cr)
    denom = np.abs(want).mean()
    assert np.abs(got - want).max() / denom < 5e-4


@pytest.mark.parametrize("engine", ["complex", "real"])
def test_runner_tflags_path(engine, tmp_path):
    """run_baselines dispatches jobs carrying flags_tf through the grouped
    path and writes complete reference-named outputs."""
    from hydra_pspec_tpu.runner import BaselineJob, run_baselines

    d, flags, fg, ninv, _ = make_problem(ntimes=12)
    job = BaselineJob(
        antpair=(0, 1), d=d, w=(~np.any(flags, 0)).astype(float),
        fgmodes=fg, S_initial=np.eye(d.shape[1]), Ninv=ninv,
        out_dir=tmp_path / "0-1", flags_tf=flags,
    )
    niter = 5
    results, timings = run_baselines(
        [job], np.zeros((2, d.shape[1])), niter, seed=3, write_niter=3,
        engine=engine, use_mesh=False,
    )
    assert len(results) == 1
    assert timings["engine"] == engine
    r = results[0]
    assert r.signal_ps.shape == (niter, d.shape[1])
    assert r.signal_cr.shape == (niter,) + d.shape
    assert np.isfinite(r.signal_ps).all()
    dps = np.load(tmp_path / "0-1" / "dps-eor.npy")
    assert dps.shape == (niter, d.shape[1])
    np.testing.assert_allclose(dps, r.signal_ps)


def test_tflags_complex_write_times_are_disjoint(tmp_path):
    """Each RunResult.write_time on the complex tflags path is that row's
    OWN write seconds (the reference's per-baseline write_data semantics,
    run-hydra-pspec.py:554-557) — the per-result values sum to the
    timings['write'] total instead of each carrying the running total."""
    from hydra_pspec_tpu.runner import run_baselines

    d, flags, fg, ninv, _ = make_problem(ntimes=12)
    jobs = [
        _mk_job(d, flags, fg, ninv, tmp_path / "0-1", (0, 1)),
        _mk_job(d, flags, fg, ninv, tmp_path / "0-2", (0, 2)),
    ]
    results, timings = run_baselines(
        jobs, np.zeros((2, d.shape[1])), 4, seed=3, nchains=2,
        write_niter=4, engine="complex", use_mesh=False,
    )
    writes = [r.write_time for r in results]
    assert len(writes) == 4 and all(w > 0 for w in writes)
    assert np.isclose(sum(writes), timings["write"], rtol=1e-9)


def test_grouped_chain_runs_and_inpaints():
    """Short grouped chain: finite outputs, chi^2 ~ 1 on unflagged cells,
    and flagged cells are in-painted (nonzero signal where w == 0)."""
    d, flags, fg, ninv, ps = make_problem(ntimes=16)
    groups = tflags.build_grouped_operators(d, flags, fg, ninv)
    ps_j = jnp.asarray(ps)
    prior = jnp.zeros((2, d.shape[1]))
    _, samples = jax.jit(
        lambda k, p: tflags.run_chain_tflags(k, groups, p, prior, 30)
    )(jax.random.key(1), ps_j)
    assert np.isfinite(np.asarray(samples.ps)).all()
    chisq = np.asarray(samples.chisq[10:])  # (niter, T, n)
    unflagged = ~flags
    chi_mean = chisq[:, unflagged].mean()
    assert 0.5 < chi_mean < 2.0, chi_mean
    # in-painting: flagged cells carry signal draws
    cr = np.asarray(samples.signal_cr[-1])
    assert np.abs(cr[flags]).min() > 0


def _mk_job(d, flags, fg, ninv, out_dir, antpair):
    from hydra_pspec_tpu.runner import BaselineJob

    return BaselineJob(
        antpair=antpair, d=d, w=(~np.any(flags, 0)).astype(float),
        fgmodes=fg, S_initial=np.eye(d.shape[1]), Ninv=ninv,
        out_dir=out_dir, flags_tf=flags,
    )


def test_tflags_batched_composition_invariance(tmp_path):
    """Real-engine tflags batches same-signature baselines into one run;
    per-row stream ids must make the batched chains reproduce per-baseline
    runs (identical PRNG streams; only f32 reassociation differs), for
    every baseline, across mixed signatures."""
    from hydra_pspec_tpu.runner import run_baselines

    ntimes, nfreqs = 12, 16
    fg = crandn(nfreqs, 3)
    ninv = np.abs(RNG.standard_normal(nfreqs)) + 1.0
    flags_a = np.zeros((ntimes, nfreqs), dtype=bool)
    flags_a[4:, 5] = True
    flags_b = np.zeros((ntimes, nfreqs), dtype=bool)
    flags_b[:3, 9] = True
    flags_b[6:, 2] = True
    # baselines 0 and 2 share signature A; baseline 1 has signature B
    sigs = [flags_a, flags_b, flags_a]
    ds = [crandn(ntimes, nfreqs) * 2 for _ in range(3)]
    prior = np.zeros((2, nfreqs))
    niter, seed = 6, 17

    jobs = [
        _mk_job(ds[i], sigs[i], fg, ninv, None, (0, i + 1))
        for i in range(3)
    ]
    batched, timings = run_baselines(
        jobs, prior, niter, seed=seed, nchains=2, write_niter=4,
        engine="real", use_mesh=False,
    )
    assert timings["engine"] == "real"
    assert timings["batch"] == 6

    # the sids contract: per-baseline runs must preserve each baseline's
    # GLOBAL position (sid = ib * nchains + ic) to reproduce its streams
    # same composition re-run is fully deterministic
    again, _ = run_baselines(
        jobs, prior, niter, seed=seed, nchains=2, write_niter=4,
        engine="real", use_mesh=False,
    )
    for a, b in zip(batched, again):
        np.testing.assert_array_equal(a.signal_ps, b.signal_ps)

    for ib in range(3):
        solo, _ = run_baselines(
            [jobs[ib]], prior, niter, seed=seed, nchains=2, write_niter=4,
            engine="real", use_mesh=False,
            global_baseline_ids=[ib],
        )
        for ic in range(2):
            want = batched[ib * 2 + ic]
            got = solo[ic]
            # identical PRNG streams; residual diff is f32 matmul
            # reassociation across different batch shapes (same
            # tolerance rationale as the mesh-padding test)
            np.testing.assert_allclose(
                got.signal_ps, want.signal_ps, rtol=2e-3, atol=1e-4)
            np.testing.assert_allclose(
                got.signal_cr, want.signal_cr, rtol=2e-3, atol=1e-3)
            np.testing.assert_allclose(
                got.chisq, want.chisq, rtol=5e-3, atol=1e-3)
            np.testing.assert_allclose(
                got.ln_post, want.ln_post, rtol=2e-3)


def test_tflags_batched_mesh_sharding():
    """The batched tflags run shards rows over the device mesh (8 virtual
    CPU devices, batch 3 baselines x 2 chains = 6 rows padded to 8) and
    matches the unsharded run."""
    from hydra_pspec_tpu.runner import run_baselines

    ntimes, nfreqs = 12, 16
    fg = crandn(nfreqs, 3)
    ninv = np.abs(RNG.standard_normal(nfreqs)) + 1.0
    flags = np.zeros((ntimes, nfreqs), dtype=bool)
    flags[5:, 7] = True
    ds = [crandn(ntimes, nfreqs) * 2 for _ in range(3)]
    prior = np.zeros((2, nfreqs))
    jobs = [_mk_job(ds[i], flags, fg, ninv, None, (0, i + 1))
            for i in range(3)]

    meshed, t_m = run_baselines(
        jobs, prior, 6, seed=5, nchains=2, write_niter=3,
        engine="real", use_mesh=True,
    )
    plain, t_p = run_baselines(
        jobs, prior, 6, seed=5, nchains=2, write_niter=3,
        engine="real", use_mesh=False,
    )
    assert len(meshed) == len(plain) == 6
    for a, b in zip(meshed, plain):
        np.testing.assert_allclose(
            a.signal_ps, b.signal_ps, rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(
            a.ln_post, b.ln_post, rtol=2e-3)


def test_tflags_resume_equivalence(tmp_path):
    """Interrupted-and-resumed tflags run ends with complete output files
    equal to an uninterrupted run (per-signature checkpoint tags)."""
    from hydra_pspec_tpu.runner import run_baselines

    ntimes, nfreqs = 12, 16
    fg = crandn(nfreqs, 3)
    ninv = np.abs(RNG.standard_normal(nfreqs)) + 1.0
    flags = np.zeros((ntimes, nfreqs), dtype=bool)
    flags[2:, 3] = True
    ds = [crandn(ntimes, nfreqs) * 2 for _ in range(2)]
    prior = np.zeros((2, nfreqs))

    full_dir = tmp_path / "full"
    jobs_full = [_mk_job(ds[i], flags, fg, ninv,
                         full_dir / f"0-{i+1}", (0, i + 1))
                 for i in range(2)]
    full, _ = run_baselines(
        jobs_full, prior, 8, seed=23, nchains=2, write_niter=4,
        engine="real", use_mesh=False,
    )

    part_dir = tmp_path / "part"
    jobs_part = [_mk_job(ds[i], flags, fg, ninv,
                         part_dir / f"0-{i+1}", (0, i + 1))
                 for i in range(2)]
    run_baselines(
        jobs_part, prior, 4, seed=23, nchains=2, write_niter=4,
        engine="real", use_mesh=False,
    )
    assert (part_dir / "checkpoint-tf0.npz").exists()
    resumed, timings = run_baselines(
        jobs_part, prior, 8, seed=23, nchains=2, write_niter=4,
        engine="real", use_mesh=False, resume=True,
    )
    assert timings["start_iter"] == 4
    for a, b in zip(full, resumed):
        np.testing.assert_array_equal(a.signal_ps, b.signal_ps)
        np.testing.assert_array_equal(a.chisq, b.chisq)
    # complete files on disk after resume
    for i in range(2):
        sub = sorted((part_dir / f"0-{i+1}").rglob("dps-eor.npy"))
        assert sub and all(np.load(p).shape[0] == 8 for p in sub)


def test_tflags_real_engine_uses_pooled_alpha_table():
    """Regression for the pooled-conditional table bug: with unequal
    groups and a bounded prior bin, the real-engine tflags draw must use
    alpha + 1 = Ntimes_TOTAL (not group 0's table). Pinned by re-deriving
    the draw with the step's own key derivation."""
    from hydra_pspec_tpu.ops.invgamma import (make_invgamma_table,
                                              sample_bandpowers_from_beta)

    rng = np.random.default_rng(77)
    ntimes, nf = 12, 16
    d = (rng.standard_normal((ntimes, nf))
         + 1j * rng.standard_normal((ntimes, nf))) / np.sqrt(2) * 2.0
    fg = (rng.standard_normal((nf, 2))
          + 1j * rng.standard_normal((nf, 2))) / np.sqrt(2)
    ninv = np.abs(rng.standard_normal(nf)) + 1.0
    flags_tf = np.zeros((ntimes, nf), dtype=bool)
    flags_tf[7:, 3] = True          # two groups of 7 and 5 times
    groups = tflags.build_grouped_operators_real(d, flags_tf, fg, ninv)
    prior = np.zeros((2, nf), dtype=np.float32)
    prior[0, 5] = 300.0
    prior[1, 5] = 0.5
    prior_j = jnp.asarray(prior)
    ps0 = jnp.asarray(
        np.abs(rng.standard_normal((1, nf))) * 10.0 + 0.5, jnp.float32)

    key = jax.random.key(3)
    igt_tot = make_invgamma_table(ntimes)
    ps_new, _ = tflags.gibbs_step_tflags_real(
        key, ps0, groups, prior_j, igt_total=igt_tot)

    # the step's bandpower key for stream id 0
    k_ps = jax.random.fold_in(jax.random.fold_in(key, 0), 999_983)
    # Gamma(alpha_total) variates of that stream, from a unit-beta draw
    probe = sample_bandpowers_from_beta(
        k_ps, jnp.ones((nf,), jnp.float32), ntimes,
        jnp.zeros((2, nf), jnp.float32), None, None)
    gam = 1.0 / probe
    # beta from the free-bin identity ps = beta / gam; the prior bin's
    # beta comes from a zero-prior twin of the same step (identical
    # streams). Everything stays float32: the in-step uniform stream is
    # drawn at beta.dtype, so an accidental float64 would change the draw.
    ps_free, _ = tflags.gibbs_step_tflags_real(
        key, ps0, groups, jnp.zeros_like(prior_j), igt_total=igt_tot)
    beta = jnp.asarray(np.asarray(ps_new[0] * gam), jnp.float32)
    beta5 = jnp.float32(float(ps_free[0, 5]) * float(gam[5]))
    ps_wrong = sample_bandpowers_from_beta(
        k_ps, beta.at[5].set(beta5), ntimes, prior_j,
        None, groups[0].ops.igt)            # group 0's table
    ps_right = sample_bandpowers_from_beta(
        k_ps, beta.at[5].set(beta5), ntimes, prior_j, None, igt_tot)
    # the step must agree with the pooled-alpha table draw...
    np.testing.assert_allclose(
        float(ps_new[0, 5]), float(ps_right[5]), rtol=1e-5)
    # ...and the group-0 table (alpha = first group's times) must give a
    # materially different value — i.e. the old wiring was a real bug
    assert abs(float(ps_wrong[5]) - float(ps_right[5])) > 1e-3 * abs(
        float(ps_right[5]))
