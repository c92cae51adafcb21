"""Smoke run of the Gibbs sampler on a GPU.

    python chip_smoke.py           # one card
    python chip_smoke.py --mesh4   # four cards: the mesh phase only

One card runs three phases on a seeded problem drawn from the sampler's own
model at the reference's shapes (203 times x 120 channels, 12 foreground
modes, 7-bin prior window; hydra_pspec_tpu/utils/synthetic.py):

1. one Gibbs solve of the float32 real engine for 4 baselines, unflagged
   and RFI-flagged, against the NumPy complex128 reference
   (tests/reference_impl.py) fed the same fluctuation draws;
2. ``runner.run_baselines`` as the CLI calls it: 100 baselines x 1 chain,
   200 iterations in chunks of 100, CR samples stored and written;
3. the CLI's ``main`` on a seeded ``.uvh5`` file.

``--mesh4`` runs 400 baselines on a 1D mesh over four cards and compares
the first 100 with a one-card run of the same jobs.

Earlier lines report what was measured; the last line is one JSON object
with the device JAX found. Any failed check raises, so the script exits
non-zero and prints no result. It exits non-zero without a GPU.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 20261016
STEP_TOL = 1e-3          # relative error of one f32 solve vs complex128
CHI2_BAND = (0.98, 1.02)
RATIO_BAND = (0.9, 1.1)
MESH_RTOL = 2e-3         # f32 op order between a 4-card and a 1-card run


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


class CompileClock:
    """Sums XLA backend compile seconds reported by JAX's monitoring."""

    def __init__(self):
        import jax

        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def check(ok, what):
    """A failed check ends the run (asserts would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def crandn(rng, *shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)) / np.sqrt(2)


def phase_step(nbl=4, **shape):
    """One real-engine solve vs the complex128 reference; returns the
    worst relative error over baselines, fields and flag cases."""
    import jax
    import jax.numpy as jnp

    import reference_impl as ref
    from hydra_pspec_tpu.models import rgibbs
    from hydra_pspec_tpu.ops import cplx
    from hydra_pspec_tpu.utils import synthetic

    solve = jax.jit(rgibbs.gcr_solve)
    errs = []
    for flagged in (False, True):
        p = synthetic.make_problem(nbl, seed=SEED + 1, flagged=flagged,
                                   **shape)
        _, ntimes, nfreqs = p.vis.shape
        rng = np.random.default_rng(SEED + 2)
        oa = crandn(rng, nbl, ntimes, nfreqs)
        ob = crandn(rng, nbl, ntimes, nfreqs)
        f_op = ref.fourier_operator(nfreqs)
        ops = rgibbs.stack_chain_operators([
            rgibbs.build_chain_operators(p.vis[i], p.w, p.fgmodes, p.ninv)
            for i in range(nbl)])
        ps = jnp.broadcast_to(jnp.asarray(p.ps_true, jnp.float32),
                              (nbl, nfreqs))
        sig, amps, _ = solve(ops, ps, cplx.from_numpy(oa @ f_op),
                             cplx.from_numpy(ob))
        sig, amps = cplx.to_numpy(sig), cplx.to_numpy(amps)
        sig_s = ref.covariance_from_pspec(p.ps_true / nfreqs**2, f_op)
        mats = ref.build_matrices(p.w, sig_s, p.ninv, p.fgmodes)
        for i in range(nbl):
            want_sig, want_amps = ref.gcr_solve_direct(
                mats, p.fgmodes, p.vis[i] * p.w, oa[i], ob[i])
            for got, want in ((sig[i], want_sig), (amps[i], want_amps)):
                errs.append(float(np.linalg.norm(got - want)
                                  / np.linalg.norm(want)))
    worst = float(np.max(errs))             # NaN if any error is NaN
    print(f"step: {nbl} baselines x (unflagged, flagged), worst relative "
          f"error vs complex128 reference {worst:.3e} (bar {STEP_TOL})")
    check(worst <= STEP_TOL, errs)
    return worst


def phase_run(nbl=100, niter=200, write_niter=100, nburn=100, **shape):
    """run_baselines as the CLI calls it, outputs written and checked."""
    import jax

    from hydra_pspec_tpu.runner import run_baselines
    from hydra_pspec_tpu.utils import synthetic
    from hydra_pspec_tpu.utils.io import SAMPLE_FILENAMES

    p = synthetic.make_problem(nbl, seed=SEED, **shape)
    _, ntimes, nfreqs = p.vis.shape
    nmodes = p.fgmodes.shape[1]
    clock = CompileClock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        run_dir = Path(tmp) / "res"
        t0 = time.perf_counter()
        results, timings = run_baselines(
            p.jobs(run_dir), p.prior, niter, seed=SEED, nchains=1,
            write_niter=write_niter, store_cr=True, run_dir=run_dir)
        wall = time.perf_counter() - t0
        want = {"signal_cr": (niter, ntimes, nfreqs),
                "signal_ps": (niter, nfreqs),
                "fg_amps": (niter, ntimes, nmodes),
                "chisq": (niter, ntimes, nfreqs), "ln_post": (niter,)}
        nbytes = 0
        for job in p.jobs(run_dir):
            for field, shp in want.items():
                f = job.out_dir / SAMPLE_FILENAMES[field]
                arr = np.load(f, mmap_mode="r")
                check(arr.shape == shp, (f, arr.shape, shp))
                nbytes += f.stat().st_size
    check(timings["engine"] == "real", timings["engine"])
    check(len(results) == nbl, len(results))
    chi2 = float(np.mean([r.chisq[nburn:].mean() for r in results]))
    ratio = synthetic.recovery_ratio(
        np.stack([r.signal_ps[nburn:] for r in results]), p.ps_true)
    finite = all(np.isfinite(r.signal_ps).all()
                 and np.isfinite(r.ln_post).all() for r in results)
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    print(f"run: {nbl} baselines x 1 chain x {niter} iterations "
          f"({ntimes}x{nfreqs}, {nmodes} modes), store_cr on, "
          f"{nbytes / 1e9:.2f} GB written and checked")
    print(f"run: wall {wall:.2f} s, compile {clock.seconds:.2f} s, "
          f"process {timings['process']:.2f} s, write "
          f"{timings['write']:.2f} s, scatter {timings['scatter']:.2f} s")
    print(f"run: peak_bytes_in_use {peak}")
    print(f"run: mean chi^2 after {nburn} burn-in iterations {chi2:.5f} "
          f"(band {CHI2_BAND}); median posterior/true bandpower on "
          f"EoR-dominated bins {ratio:.4f} (band {RATIO_BAND})")
    check(finite, "non-finite samples")
    check(CHI2_BAND[0] <= chi2 <= CHI2_BAND[1], chi2)
    check(RATIO_BAND[0] <= ratio <= RATIO_BAND[1], ratio)
    return chi2, ratio


def phase_cli(nbl=4, niter=20, **shape):
    """``hydra_pspec_tpu.cli.run.main`` on a seeded, RFI-flagged .uvh5."""
    missing = [m for m in ("h5py", "yaml")
               if importlib.util.find_spec(m) is None]
    if missing:
        print(f"cli: phase left out: {missing} not installed (the CLI's "
              ".uvh5 reader needs h5py, its YAML configs pyyaml)")
        return None
    from hydra_pspec_tpu.cli.run import main
    from hydra_pspec_tpu.utils import synthetic

    p = synthetic.make_problem(nbl, seed=SEED + 3, flagged=True, **shape)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        fp = p.write_uvh5(Path(tmp) / "vis.uvh5")
        rc = main([str(fp), "--out_dir", tmp, "--dirname", "res",
                   "--Niter", str(niter), "--write_Niter", str(niter // 2),
                   "--seed", str(SEED), *p.cli_args()])
        check(rc == 0, rc)
        timings = json.loads((Path(tmp) / "res" / "timings.json").read_text())
        dps = np.load(Path(tmp) / "res" / "0-1" / "dps-eor.npy")
    check(timings["engine"] == "real", timings)
    check(dps.shape == (niter, p.vis.shape[-1]), dps.shape)
    check(np.isfinite(dps).all(), "non-finite CLI samples")
    print(f"cli: {nbl} flagged baselines x {niter} iterations, engine "
          f"{timings['engine']}, process "
          f"{timings['rank_0_timers']['process']:.2f} s")
    return timings


def phase_mesh(nbl=400, niter=200, write_niter=100, ncompare=100, **shape):
    """400 baselines on a 1D mesh over every card vs the first 100 on one
    card, in one process. Streams are per chain, so only op order
    differs."""
    import jax

    from hydra_pspec_tpu.runner import run_baselines
    from hydra_pspec_tpu.utils import synthetic

    devices = jax.devices()
    p = synthetic.make_problem(nbl, seed=SEED, **shape)
    jobs = p.jobs()
    kw = dict(seed=SEED, nchains=1, write_niter=write_niter, store_cr=False)
    walls = {}
    t0 = time.perf_counter()
    res_mesh, tm = run_baselines(jobs, p.prior, niter, use_mesh=True,
                                 mesh_devices=devices, **kw)
    walls[len(devices)] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_one, _ = run_baselines(jobs[:ncompare], p.prior, niter,
                               use_mesh=True, mesh_devices=devices[:1], **kw)
    walls[1] = time.perf_counter() - t0
    check(tm["engine"] == "real", tm["engine"])
    diffs = []
    for a, b in zip(res_mesh[:ncompare], res_one):
        for x, y in ((a.signal_ps, b.signal_ps), (a.ln_post, b.ln_post)):
            np.testing.assert_allclose(x, y, rtol=MESH_RTOL)
            diffs.append(float(np.max(np.abs(x - y) / np.abs(y))))
    worst = float(np.max(diffs))
    print(f"mesh: {nbl} baselines x {niter} iterations on "
          f"{len(devices)} cards: wall {walls[len(devices)]:.2f} s "
          f"({nbl // len(devices)} baselines per card); first {ncompare} "
          f"on 1 card: wall {walls[1]:.2f} s")
    print(f"mesh: signal_ps/ln_post of the first {ncompare} baselines, "
          f"worst relative difference {worst:.3e} (rtol {MESH_RTOL})")
    return walls, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found platform "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    if args.mesh4 and len(devices) != 4:
        print(f"chip_smoke --mesh4: needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(REPO), str(REPO / "tests")]
    from hydra_pspec_tpu import device

    print(f"compile cache: {device.setup_compile_cache()}")
    print(f"card: {card_line()}")
    print(f"jax.devices(): {devices}")
    if args.mesh4:
        phase_mesh()
    else:
        phase_step()
        phase_run()
        phase_cli()
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
