"""CLI driver: config-compatible with the reference's run-hydra-pspec.py
(same YAML keys, same per-baseline file conventions, same output layout and
provenance artifacts), executing on the JAX device mesh instead of MPI.

Usage:
    python -m hydra_pspec_tpu.cli.run --config test_data/config.yaml [flags]

Reading ``.uvh5`` files needs ``h5py`` and ``--config`` YAML files need
``pyyaml``; both are imported only where those formats are read.

Differences from the reference by design:
  * no mpirun — one process per host, devices via jax; multi-host runs use
    --num_processes/--process_id/--coordinator (jax.distributed) and each
    host loads only its baseline block (fixing the rank-0 load bottleneck,
    scaling_tests_README.md:74-80).
  * --nchains runs multiple independent chains per baseline and reports the
    split-R-hat convergence diagnostic.
  * checkpoint/resume via --resume.
"""
import argparse
import sys
import time
import typing
from dataclasses import fields
from pathlib import Path

import numpy as np

from .. import device
from ..utils.config import RunConfig, resolve_per_baseline
from ..utils import provenance, uvh5 as uv
from ..utils.io import add_mtime_to_filepath
from ..parallel.partition import local_indices
from ..runner import BaselineJob, run_baselines, gelman_rubin


def build_parser():
    p = argparse.ArgumentParser(
        description="JAX hydra-pspec driver (config-compatible)."
    )
    p.add_argument("--config", type=str, help="YAML config (reference format)")
    p.add_argument("file_paths", nargs="*", help="uvh5 visibility file(s)")
    hints = typing.get_type_hints(RunConfig)
    for f in fields(RunConfig):
        if f.name == "file_paths":
            continue
        arg = f"--{f.name}"
        # dispatch on the RESOLVED dataclass annotation so new RunConfig
        # fields get the right CLI type automatically; Optional[T] unwraps
        # to T (substring-matching str(annotation) mis-dispatched e.g.
        # list[int] or string annotations containing "int")
        t = hints.get(f.name, str)
        if typing.get_origin(t) is typing.Union:
            args_t = [a for a in typing.get_args(t) if a is not type(None)]
            t = args_t[0] if len(args_t) == 1 else str
        if t is bool:
            # --X / --no-X so defaults-True knobs (store_cr) can be disabled
            p.add_argument(arg, action=argparse.BooleanOptionalAction,
                           default=None)
        elif t is int:
            p.add_argument(arg, type=int, default=None)
        elif t is float:
            p.add_argument(arg, type=float, default=None)
        else:
            p.add_argument(arg, type=str, default=None)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None)
    return p


def load_config(argv=None):
    args = build_parser().parse_args(argv)
    overrides = {
        k: v
        for k, v in vars(args).items()
        if k not in ("config", "num_processes", "process_id", "coordinator")
        and v not in (None, [])
    }
    if args.config:
        cfg = RunConfig.from_yaml(args.config, **overrides)
    else:
        cfg = RunConfig.from_dict(overrides)
    return cfg, args


def setup_precision(cfg):
    """x64 (and with it the complex parity engine) on the CPU; the float32
    real engine on an accelerator (device.select_precision)."""
    import jax

    if device.select_precision(cfg.precision) == "x64":
        jax.config.update("jax_enable_x64", True)


def legendre_fgmodes(nfreqs: int, nmodes: int) -> np.ndarray:
    """Legendre-polynomial foreground basis fallback (reference
    run-hydra-pspec.py:456-460)."""
    from numpy.polynomial import legendre

    x = np.linspace(-1.0, 1.0, nfreqs)
    cols = []
    for i in range(nmodes):
        c = np.zeros(i + 1)
        c[i] = 1.0
        cols.append(legendre.legval(x, c))
    return np.stack(cols, axis=1)


def prepare_jobs(cfg: RunConfig, out_dir: Path, process_id=0, num_processes=1):
    """Rank-local data load: read only this process's baseline block
    (reference loads everything on rank 0, run-hydra-pspec.py:290-477)."""
    antpairs = uv.parse_ant_str(cfg.ant_str)
    t0 = time.perf_counter()
    all_bls = []
    freqs = None
    for fp in sorted(cfg.file_paths):
        bls, freqs = uv.read_uvh5(fp, antpairs=antpairs, freq_range=cfg.freq_range)
        all_bls.extend(bls)
    if not all_bls:
        raise SystemExit("No baselines found in input file(s).")
    nfreqs = all_bls[0].vis.shape[1]

    mine = list(local_indices(len(all_bls), process_id, num_processes))
    jobs = []
    for i in mine:
        bl = all_bls[i]
        a, b = bl.antpair
        bl_str = f"{a}-{b}"
        d = np.array(bl.vis)

        flags = resolve_per_baseline(cfg.flags, cfg.flags_file, bl_str)
        if flags is None:
            flags = bl.flags
        nsamples = resolve_per_baseline(cfg.nsamples, cfg.nsamples_file, bl_str)
        noise = resolve_per_baseline(cfg.noise, cfg.noise_file, bl_str)
        if noise is not None:
            noise = np.array(noise)
            if nsamples is not None:
                noise /= np.sqrt(nsamples)
            d = d + noise

        sigcov0 = resolve_per_baseline(cfg.sigcov0, cfg.sigcov0_file, bl_str)
        if sigcov0 is None:
            sigcov0 = np.eye(nfreqs)

        noise_cov = resolve_per_baseline(cfg.noise_cov, cfg.noise_cov_file, bl_str)
        if noise_cov is not None:
            ninv = np.linalg.inv(noise_cov)
        else:
            ninv = np.eye(nfreqs) / 10.0**2  # reference fallback (:438)

        freq_str = _freq_str(bl.freqs)
        fgm = resolve_per_baseline(
            cfg.fgmodes, cfg.fgmodes_file, bl_str,
            default_name=f"evecs-{freq_str}.npy",
        )
        if fgm is None:
            fgm = legendre_fgmodes(nfreqs, cfg.Nfgmodes)
        fgm = fgm[:, : cfg.Nfgmodes]

        flags_b = np.asarray(flags, dtype=bool)
        w_any = uv.collapse_flags_any_time(flags_b)
        bl_out = out_dir / bl_str
        jobs.append(
            BaselineJob(
                antpair=bl.antpair, d=d, w=w_any, fgmodes=fgm,
                S_initial=sigcov0, Ninv=ninv, out_dir=bl_out,
                # opt-in per-time flag patterns (reference FIXME :541)
                flags_tf=flags_b if cfg.time_flags else None,
            )
        )
    t_load = time.perf_counter() - t0
    return jobs, nfreqs, len(all_bls), t_load, mine


def _freq_str(freqs_hz):
    f = np.asarray(freqs_hz) / 1e6
    return f"{f.min():.3f}-{f.max():.3f}MHz"


def build_prior(cfg: RunConfig, nfreqs: int) -> np.ndarray:
    """Prior window around delay 0 (reference run-hydra-pspec.py:504-517)."""
    prior = np.zeros((2, nfreqs))
    if cfg.ps_prior_lo != 0 or cfg.ps_prior_hi != 0:
        sl = slice(nfreqs // 2 - cfg.n_ps_prior_bins,
                   nfreqs // 2 + cfg.n_ps_prior_bins + 1)
        prior[0, sl] = cfg.ps_prior_hi
        prior[1, sl] = cfg.ps_prior_lo
    return prior


def _gather_per_baseline(local, jobs, n_baselines, num_processes):
    """Gather per-baseline values (a scalar or a fixed-width 1D array per
    baseline) from every process — the equivalent of the reference's ``comm.gather(write_timings)`` (run-hydra-pspec.py:557),
    via ``multihost_utils.process_allgather`` over padded fixed-shape
    buffers (ragged rank blocks pad with NaN/-1 sentinels). Returns a list
    with one ``[(bl_str, value), ...]`` entry per rank."""
    order = [f"{j.antpair[0]}_{j.antpair[1]}" for j in jobs]
    vals = [np.atleast_1d(np.asarray(local[bl], dtype=np.float64))
            for bl in order]
    if num_processes <= 1:
        return [list(zip(order, vals))]
    from jax.experimental import multihost_utils

    width = vals[0].size if vals else 1
    maxn = -(-n_baselines // num_processes)  # block rule: max local count
    ants = np.full((maxn, 2), -1, dtype=np.int64)
    buf = np.full((maxn, width), np.nan)
    for i, j in enumerate(jobs):
        ants[i] = j.antpair
        buf[i] = vals[i]
    g_ants = np.asarray(multihost_utils.process_allgather(ants))
    g_buf = np.asarray(multihost_utils.process_allgather(buf))
    out = []
    for r in range(num_processes):
        entries = []
        for i in range(maxn):
            a, b = g_ants[r, i]
            if a < 0:
                continue
            entries.append((f"{a}_{b}", g_buf[r, i]))
        out.append(entries)
    return out


def main(argv=None):
    t_total0 = time.perf_counter()
    cfg, args = load_config(argv)
    device.setup_compile_cache()

    if args.num_processes > 1:
        from ..parallel.mesh import initialize_distributed

        initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    # AFTER distributed init: precision="auto" reads jax.default_backend(),
    # which initializes the XLA backend — doing that before
    # jax.distributed.initialize() is an error in multi-process runs.
    setup_precision(cfg)
    is_rank0 = args.process_id == 0

    # Output dir setup (reference run-hydra-pspec.py:334-365).
    out_root = Path(cfg.out_dir)
    if not cfg.dirname:
        # Default name embeds the frequency span (reference :337) — a cheap
        # header-only read.
        import h5py

        with h5py.File(sorted(cfg.file_paths)[0], "r") as f:
            fr = np.asarray(f["Header/freq_array"][:]).reshape(-1)
        if cfg.freq_range:
            fr = uv.filter_freqs(cfg.freq_range, fr / 1e6) * 1e6
        dirname = f"results-{_freq_str(fr)}-Niter-{cfg.Niter}"
    else:
        dirname = cfg.dirname + ("-map-estimate" if cfg.map_estimate else "")
    out_dir = out_root / dirname
    if is_rank0:
        if out_dir.exists() and not cfg.clobber and not cfg.resume:
            add_mtime_to_filepath(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        provenance.write_git_json(out_dir)
        provenance.write_args_json(out_dir, cfg.to_dict())
        provenance.touch_slurm_job_file(out_dir)
        if cfg.verbose:
            print(f"Writing output(s) to {out_dir.absolute()}")

    jobs, nfreqs, n_baselines, t_load, global_ids = prepare_jobs(
        cfg, out_dir, args.process_id, args.num_processes
    )
    prior = build_prior(cfg, nfreqs)

    results, timings = run_baselines(
        jobs,
        prior,
        cfg.Niter,
        seed=cfg.seed,
        nchains=cfg.nchains,
        write_niter=cfg.write_Niter,
        map_estimate=cfg.map_estimate,
        store_cr=cfg.store_cr,
        jitter=cfg.jitter,
        dtype=None,
        engine=cfg.engine,
        solver=cfg.solver,
        checkpoint_niter=cfg.checkpoint_Niter,
        resume=cfg.resume,
        run_dir=out_dir,
        process_id=args.process_id,
        num_processes=args.num_processes,
        n_global_baselines=n_baselines,
        global_baseline_ids=global_ids,
        verbose=cfg.verbose and is_rank0,
        profile_dir=cfg.profile_dir,
    )
    t_process = timings["process"]
    t_scatter = timings["scatter"]

    # Convergence diagnostic over chains (new capability): computed per
    # local baseline, gathered to rank 0, and persisted as rhat.json so
    # downstream tooling sees it (not just the verbose print).
    if cfg.nchains > 1:
        local_rhat = {}
        for ib, job in enumerate(jobs):
            chains = np.stack(
                [r.signal_ps for r in results if r.antpair == job.antpair]
            )
            rhat = gelman_rubin(chains)
            local_rhat[f"{job.antpair[0]}_{job.antpair[1]}"] = rhat
            if cfg.verbose and is_rank0:
                print(
                    f"baseline {job.antpair}: split-Rhat max "
                    f"{np.nanmax(rhat):.3f} median {np.nanmedian(rhat):.3f}"
                )
        all_rhat = _gather_per_baseline(
            local_rhat, jobs, n_baselines, args.num_processes)
        if is_rank0:
            provenance.write_rhat_json(out_dir, all_rhat)

    # Gather every rank's true per-baseline write times (the reference's
    # comm.gather(write_timings), run-hydra-pspec.py:554-557); sum over
    # chain dirs per baseline.
    local_wt = {}
    for j in jobs:
        bl = f"{j.antpair[0]}_{j.antpair[1]}"
        local_wt[bl] = float(sum(
            r.write_time for r in results if r.antpair == j.antpair))
    all_wt = _gather_per_baseline(local_wt, jobs, n_baselines,
                                  args.num_processes)

    # Barrier + gather equivalent: single process group sync.
    t_barrier0 = time.perf_counter()
    if args.num_processes > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("hydra_pspec_tpu_end")
    t_barrier = time.perf_counter() - t_barrier0

    if is_rank0:
        t_total = time.perf_counter() - t_total0
        write_data = [
            {
                "rank": rank,
                "ant_pairs": [bl for bl, _ in entries],
                "write_times": [float(np.sum(v)) for _, v in entries],
            }
            for rank, entries in enumerate(all_wt)
        ]
        provenance.write_timings_json(
            out_dir,
            num_ranks=args.num_processes,
            num_baselines=n_baselines,
            load_data=t_load,
            scatter=t_scatter,
            process=t_process,
            barrier=t_barrier,
            total=t_total,
            write_data=write_data,
            engine=timings["engine"],
        )
        provenance.write_resources_json(out_dir)
        if cfg.verbose:
            print(
                f"done: {n_baselines} baselines x {cfg.nchains} chains x "
                f"{cfg.Niter} iters in {t_process:.2f}s "
                f"({n_baselines * cfg.nchains * cfg.Niter / t_process:.1f} "
                f"baseline-iters/s)"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
