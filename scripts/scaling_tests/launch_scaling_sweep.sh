#!/bin/bash
# Multi-process strong-scaling sweep driver — the equivalent of the
# reference's SLURM harness (scripts/scaling_tests/create_jobscript.sh +
# jobscript.sh.template: mpirun over rank counts). Here each sweep point
# launches N jax.distributed processes of the CLI; on one machine they talk
# over localhost, across nodes submit jobscript.slurm.template instead.
#
# One process per accelerator: a JAX process reserves most of a GPU's
# memory, so N processes on one host each get their own card
# (CUDA_VISIBLE_DEVICES=p, set when nvidia-smi lists at least N cards) or
# run on the CPU (JAX_PLATFORMS=cpu) — never N processes on one card.
#
# Usage:
#   scripts/scaling_tests/launch_scaling_sweep.sh DATA_DIR OUT_DIR "1 2 4"
#
#   DATA_DIR: output of scripts/make_scaling_data.py (vis.uvh5 + aux/)
#   OUT_DIR:  one subdirectory per sweep point is created (n1/ n2/ ...)
#   third arg: process counts to sweep
#
# After the sweep, the REFERENCE's plotter consumes the results unmodified:
#   python <reference>/scripts/scaling_tests/plot_speed_up.py \
#       --results_dir OUT_DIR --timer process --reference_nranks 1
set -euo pipefail

DATA_DIR=${1:?data dir (make_scaling_data.py output)}
OUT_DIR=${2:?output dir}
COUNTS=${3:-"1 2"}
NITER=${NITER:-4}
NFGMODES=${NFGMODES:-12}
PORT=${PORT:-12411}
REPO=$(cd "$(dirname "$0")/../.." && pwd)

run_args=(
  "$DATA_DIR/vis.uvh5"
  --noise_cov "$DATA_DIR/aux" --noise_cov_file noise-cov.npy
  --fgmodes "$DATA_DIR/aux" --fgmodes_file fgmodes.npy
  --sigcov0 "$DATA_DIR/aux" --sigcov0_file eor-cov.npy
  --noise "$DATA_DIR/aux" --noise_file noise.npy
  --Niter "$NITER" --Nfgmodes "$NFGMODES" --seed 7123689
  --write_Niter "$NITER"
)

# CPUS_PER_PROC: pin each process to its own core block (taskset) so a
# localhost sweep emulates the reference's 1-CPU-per-rank fixture
# (jobscript.sh.template:9) instead of letting every process's XLA thread
# pool fight over all cores — without pinning, localhost "scaling" numbers
# are meaningless.
CPUS_PER_PROC=${CPUS_PER_PROC:-0}

NGPU=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU' || true)

for n in $COUNTS; do
  out="$OUT_DIR/n$n"
  mkdir -p "$out"
  echo "=== sweep point: $n process(es) ==="
  pids=()
  for ((p = 0; p < n; p++)); do
    pin=()
    if [ "$CPUS_PER_PROC" -gt 0 ]; then
      # wrap around the physical cores: with n processes > cores the sweep
      # point is OVERSUBSCRIBED (2 procs/core at n=8 on 4 cores) — label
      # that honestly in the results; the wrap keeps each process pinned
      # to a fixed core instead of failing on nonexistent core ids
      ncpu=$(nproc)
      lo=$(((p * CPUS_PER_PROC) % ncpu))
      hi=$((lo + CPUS_PER_PROC - 1))
      pin=(taskset -c "$lo-$hi")
    fi
    if [ "$NGPU" -ge "$n" ]; then
      dev=(CUDA_VISIBLE_DEVICES="$p")
    else
      dev=(JAX_PLATFORMS=cpu)
    fi
    env PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" "${dev[@]}" \
      "${pin[@]}" \
      python -m hydra_pspec_tpu.cli.run "${run_args[@]}" \
      --out_dir "$out" --dirname res --clobber \
      --num_processes "$n" --process_id "$p" \
      --coordinator "${COORDINATOR:-localhost:$PORT}" &
    pids+=($!)
  done
  for pid in "${pids[@]}"; do wait "$pid"; done
  PORT=$((PORT + 1))
  # plotter layout: one timings.json per sweep-point directory
  cp "$out/res/timings.json" "$out/timings.json"
done
echo "sweep complete: $OUT_DIR"
