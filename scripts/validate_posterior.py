"""Posterior validation — the quantitative version of the reference's
by-eye validation procedure (test_data/README.md:36-49 +
plot-test-data-results.py): run multiple independent chains of the
float32 real engine on the reference's EoR+FG data and accept them with an
MC-error-aware comparison against the committed long-run oracle posterior
(tests/oracle_posterior.json, from the independent NumPy implementation of
the reference algorithm):

  * per delay bin: |Δ mean log ps| < z_max · σ_MC, where σ_MC combines
    both runs' ESS-scaled posterior sds (hydra_pspec_tpu.utils.mcstats)
  * CI overlap: our posterior median inside the oracle's 90% CI in ≥95%
    of bins
  * convergence gate on the run itself: split-R-hat max ≤ 1.1
  * chi² over unflagged channels within 2% of 1

    python scripts/validate_posterior.py --data <reference test_data> \
        --niter 12000 --nchains 16              # on the GPU
    JAX_PLATFORMS=cpu python scripts/validate_posterior.py \
        --data <reference test_data> --niter 3000 --label cpu_real_engine

Merges the entry under --label into the --out JSON file (replaces the
former (0.85, 1.2) truth-ratio bracketing, which could hide a ~15% bias).
The reference's test_data is not shipped with this repository.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True,
                   help="the reference's test_data directory")
    p.add_argument("--niter", type=int, default=400)
    p.add_argument("--nburn", type=int, default=120)
    p.add_argument("--nchains", type=int, default=4)
    p.add_argument("--solver", default="auto")
    p.add_argument("--flag_channels", default=None,
                   help="comma list / a-b ranges of channels to RFI-flag "
                        "(e.g. '12,30-33,77-79,100') — validates the "
                        "flagged/in-painting branch; chi^2 is then "
                        "assessed on unflagged channels only")
    p.add_argument("--label", default=None,
                   help="entry name in the output JSON (merged into the "
                        "existing file); default derives from backend/"
                        "flags")
    p.add_argument("--oracle", default=str(REPO / "tests" /
                                           "oracle_posterior.json"))
    p.add_argument("--no_oracle", action="store_true",
                   help="explicitly waive the oracle gate (e.g. a flag "
                        "pattern with no committed oracle case); without "
                        "this, a missing oracle case is an ERROR — the "
                        "gate this script exists to apply must not be "
                        "droppable by accident")
    p.add_argument("--out", default="validate_posterior.json")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from hydra_pspec_tpu import device
    from hydra_pspec_tpu.models import rgibbs
    from hydra_pspec_tpu.runner import gelman_rubin
    from hydra_pspec_tpu.utils.uvh5 import read_uvh5

    td = Path(args.data)
    bls, _ = read_uvh5(td / "vis-eor-fgs.uvh5")
    d = bls[0].vis + np.load(td / "0-1" / "noise.npy")
    noise_cov = np.load(td / "0-1" / "noise-cov.npy")
    fgmodes = np.load(td / "0-1" / "fgmodes.npy")[:, :12]
    eor_cov = np.load(td / "0-1" / "eor-cov.npy")
    nfreqs = d.shape[1]
    w = np.ones(nfreqs)
    if args.flag_channels:
        for part in args.flag_channels.split(","):
            if "-" in part:
                a, b = part.split("-")
                w[int(a): int(b) + 1] = 0
            else:
                w[int(part)] = 0
    unflagged = w.astype(bool)
    ninv = 1.0 / np.diagonal(noise_cov)
    # reference acceptance config: prior [0.1, 2] over +-3 delay-0 bins
    prior = np.zeros((2, nfreqs), dtype=np.float32)
    prior[0, nfreqs // 2 - 3: nfreqs // 2 + 4] = 2.0
    prior[1, nfreqs // 2 - 3: nfreqs // 2 + 4] = 0.1

    ops1 = rgibbs.build_chain_operators(d, w, fgmodes, ninv)
    ops_b = rgibbs.broadcast_chain_operators(ops1, args.nchains)
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    ps0 = np.clip(np.diagonal(F @ eor_cov @ F.conj().T).real, 0, None)
    ps_b = jnp.broadcast_to(
        jnp.asarray(ps0, dtype=jnp.float32), (args.nchains, nfreqs))
    prior_j = jnp.asarray(prior)
    prior_idx = jnp.asarray(np.nonzero(np.any(prior > 0, axis=0))[0])

    device.setup_compile_cache()
    t0 = time.perf_counter()
    # flagged runs need per-channel chi (store_cr=True) to assess only
    # unflagged channels: a flagged channel's "chi" is |in-painted
    # model|^2 Ninv by the reference's convention (pspec.py:447-452)
    store_cr = bool(args.flag_channels)
    _, samples = rgibbs.run_chain_jit(
        jax.random.key(7123689), ops_b, ps_b, prior_j, args.niter,
        False, 0.0, store_cr, prior_idx, args.solver,
        not args.flag_channels,
    )
    ps = np.asarray(samples.ps)          # (niter, nchains, nfreqs)
    chisq = np.asarray(samples.chisq)
    if store_cr:                         # (niter, nchains, nt, nf)
        chisq = chisq[:, :, :, unflagged].mean(axis=(2, 3))
    lnp = np.asarray(samples.ln_post)
    wall = time.perf_counter() - t0

    # truth from the EoR-only visibilities
    bls_e, _ = read_uvh5(td / "vis-eor.uvh5")
    ds = np.fft.fftshift(
        np.fft.fft(np.fft.ifftshift(bls_e[0].vis, axes=1), axis=1), axes=1)
    dps_true = (np.abs(ds) ** 2).mean(axis=0)

    post = ps[args.nburn:]               # (npost, nchains, nfreqs)
    pwm = np.average(
        post.reshape(-1, nfreqs), weights=lnp[args.nburn:].reshape(-1), axis=0
    )
    edge = np.r_[0:40, 80:120]
    ratio = pwm[edge] / dps_true[edge]
    rhat = gelman_rubin(np.swapaxes(post, 0, 1))

    # MC-error-aware acceptance against the committed long-run oracle
    from hydra_pspec_tpu.utils.mcstats import (compare_to_oracle,
                                               oracle_acceptance)

    oracle_art = json.loads(Path(args.oracle).read_text())
    oracle_case = None
    if not args.flag_channels:
        oracle_case = "unflagged"
    elif args.flag_channels == oracle_art.get("flagged", {}).get(
            "flag_channels"):
        oracle_case = "flagged"
    if oracle_case is None and not args.no_oracle:
        sys.exit(
            f"--flag_channels={args.flag_channels!r} matches no committed "
            f"oracle case (flagged oracle is "
            f"{oracle_art.get('flagged', {}).get('flag_channels')!r}); "
            "regenerate the oracle for this pattern "
            "(scripts/make_oracle_posterior.py) or pass --no_oracle to "
            "waive the gate EXPLICITLY")
    cmp = None
    if oracle_case is not None:
        cmp = compare_to_oracle(np.swapaxes(post, 0, 1),
                                oracle_art[oracle_case])
        cmp["oracle_case"] = oracle_case

    chi_mean = float(chisq[args.nburn:].mean())
    rhat_max = float(np.nanmax(rhat))
    gates = {
        "chisq": abs(chi_mean - 1.0) < 0.02,
        "rhat": rhat_max <= 1.1,
        # None only when the caller EXPLICITLY waived it (--no_oracle);
        # a silently missing oracle comparison is an error above
        "oracle": oracle_acceptance(cmp) if cmp is not None else None,
    }
    if cmp is None:
        gates["oracle_waived"] = True
    verdict = {
        "backend": jax.default_backend(),
        "engine": "real",
        "solver": args.solver,
        **({"flag_channels": args.flag_channels}
           if args.flag_channels else {}),
        "niter": args.niter,
        "nchains": args.nchains,
        "wall_s": round(wall, 2),
        "chisq_postburn_mean": round(chi_mean, 5),
        "ratio_median": round(float(np.median(ratio)), 4),
        "ratio_p5": round(float(np.percentile(ratio, 5)), 4),
        "ratio_p95": round(float(np.percentile(ratio, 95)), 4),
        "split_rhat_median": round(float(np.nanmedian(rhat)), 4),
        "split_rhat_max": round(rhat_max, 4),
        **({"oracle_compare": cmp} if cmp is not None else {}),
        "gates": gates,
        "pass": all(v for v in gates.values() if v is not None),
    }

    label = args.label or "_".join(
        [verdict["backend"], "real"]
        + (["flagged"] if args.flag_channels else []))
    out_path = Path(args.out)
    merged = (json.loads(out_path.read_text())
              if out_path.exists() else {})
    merged[label] = verdict
    out_path.write_text(json.dumps(merged, indent=1) + "\n")
    print(json.dumps({label: verdict}))
    return 0 if verdict["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
