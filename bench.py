"""Benchmark of the float32 real engine on one GPU.

    python bench.py [--baselines 100] [--niter 100] [--reps 5]

The problem is drawn from a seed at the reference's shapes (203 times x
120 channels, 12 foreground modes, 7-bin prior window;
hydra_pspec_tpu/utils/synthetic.py). Two things are timed:

* the compiled chain, ``rgibbs.run_chain_jit`` with CR samples kept on the
  device, once per XLA solver (``chol``, ``recinv``): the median of
  ``--reps`` runs of ``--niter`` iterations, each ended by
  ``block_until_ready``, compilation excluded;
* ``runner.run_baselines`` end to end as the CLI calls it, samples fetched
  and written to a scratch directory (``store_cr`` on).

Earlier lines report progress; the last line is one JSON object with the
device JAX found, the card's name and power limit, and the numbers. It
exits non-zero without a GPU.
"""
import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SOLVERS = ("chol", "recinv")


def algorithmic_flops(ntimes, nfreqs, nmodes):
    """Real FLOPs of one chain-iteration's complex matmuls at the true
    dims (8 per complex multiply-add; the system inverse counted as one
    application): FG reduction, the two delay transforms, the solve, the
    amplitude recovery and the residual."""
    def zmm(a, b, c):
        return 8 * a * b * c

    nf, nt, mm = nfreqs, ntimes, nmodes
    return int(
        zmm(mm, nf, nt) + zmm(nf, mm, nt)
        + 2 * zmm(nf, nf, nt)
        + zmm(nf, nf, nt)
        + zmm(mm, mm, nt) + zmm(mm, nf, nt) + zmm(nf, mm, nt)
    )


def time_chain(problem, solver, niter, reps):
    """Median seconds per iteration of the compiled chain, and its
    compile seconds."""
    import jax
    import jax.numpy as jnp

    from hydra_pspec_tpu.models import rgibbs

    nbl, _, nfreqs = problem.vis.shape
    ops = rgibbs.stack_chain_operators([
        rgibbs.build_chain_operators(problem.vis[i], problem.w,
                                     problem.fgmodes, problem.ninv)
        for i in range(nbl)])
    ps0 = jnp.full((nbl, nfreqs), float(nfreqs), jnp.float32)
    prior = jnp.asarray(problem.prior, jnp.float32)
    prior_idx = jnp.asarray(np.nonzero(np.any(problem.prior > 0, 0))[0])

    def once(rep):
        out = rgibbs.run_chain_jit(
            jax.random.fold_in(jax.random.key(0), rep), ops, ps0, prior,
            niter=niter, store_cr=True, prior_idx=prior_idx, solver=solver,
            all_unflagged=bool(np.all(problem.w == 1)))
        return jax.block_until_ready(out)

    t0 = time.perf_counter()
    _, samples = once(reps)
    compile_s = time.perf_counter() - t0
    chi2 = float(jnp.mean(samples.chisq[-5:]))
    walls = []
    for rep in range(reps):
        t0 = time.perf_counter()
        once(rep)
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls)) / niter, compile_s, chi2, walls


def time_run(problem, niter):
    """run_baselines end to end with outputs written; its timings."""
    from hydra_pspec_tpu.runner import run_baselines

    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        t0 = time.perf_counter()
        _, timings = run_baselines(
            problem.jobs(Path(tmp) / "res"), problem.prior, niter, seed=0,
            write_niter=min(100, niter), store_cr=True)
        wall = time.perf_counter() - t0
    return wall, timings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baselines", type=int, default=100)
    ap.add_argument("--niter", type=int, default=100)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs a GPU; JAX found platform "
              f"{devices[0].platform!r}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from hydra_pspec_tpu import device
    from hydra_pspec_tpu.utils import synthetic

    device.setup_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    problem = synthetic.make_problem(args.baselines, seed=0)
    nbl, ntimes, nfreqs = problem.vis.shape
    nmodes = problem.fgmodes.shape[1]

    chain = {}
    for solver in SOLVERS:
        sec, compile_s, chi2, walls = time_chain(
            problem, solver, args.niter, args.reps)
        chain[solver] = {
            "ms_per_iter": sec * 1e3,
            "baseline_iters_per_s": nbl / sec,
            "compile_s": compile_s,
            "rep_walls_s": walls,
            "chisq_last5": chi2,
        }
        print(f"[bench] chain {solver}: {sec * 1e3:.4f} ms/iter at "
              f"B={nbl}, compile {compile_s:.1f} s, chi^2 {chi2:.4f}",
              file=sys.stderr)
    wall, timings = time_run(problem, args.niter)
    print(f"[bench] run_baselines: wall {wall:.3f} s, process "
          f"{timings['process']:.3f} s, write {timings['write']:.3f} s",
          file=sys.stderr)
    d = devices[0]
    print(json.dumps({
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(devices)},
        "card": card,
        "shape": {"baselines": nbl, "ntimes": ntimes, "nfreqs": nfreqs,
                  "nmodes": nmodes, "niter": args.niter},
        "solver_auto": device.select_solver("auto"),
        "chain": chain,
        "run_baselines": {
            "wall_s": wall, "process_s": timings["process"],
            "write_s": timings["write"], "scatter_s": timings["scatter"],
            "baseline_iters_per_s": nbl * args.niter / timings["process"],
            "engine": timings["engine"],
        },
        "algorithmic_flops_per_chain_iter": algorithmic_flops(
            ntimes, nfreqs, nmodes),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
