"""Multi-baseline, multi-chain execution engine.

The reference distributes baselines over MPI ranks and times over forked
processes (run-hydra-pspec.py:483, pspec.py:287). Here the (baseline x
chain) product is one batch axis, executed by one of two engines:

  * ``engine="real"`` (float32 production): the batch-first real-pair
    engine (models/rgibbs.py), whose hot solve is one batched XLA
    factorisation for the whole batch;
  * ``engine="complex"`` (CPU / x64 parity, dense noise models): the
    complex engine (models/gibbs.py) vmapped over stacked chain operators.

Incremental writes land every ``write_niter`` iterations with the
reference's filenames (crash resilience, pspec.py:625-638) plus a
resumable checkpoint (new capability; the reference cannot restart,
SURVEY.md §5.4).
"""
import time
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import device
from .models import gcr, gibbs, rgibbs
from .parallel import mesh as pmesh
from .parallel import partition as ppart
from .utils import io as hio


@dataclass
class BaselineJob:
    """One baseline's inference inputs (the reference's per-baseline dict,
    run-hydra-pspec.py:462-470)."""

    antpair: tuple
    d: np.ndarray              # (Ntimes, Nfreqs) complex, noise-injected
    w: np.ndarray              # (Nfreqs,) 1 = keep
    fgmodes: np.ndarray        # (Nfreqs, Nmodes)
    S_initial: np.ndarray      # (Nfreqs, Nfreqs) or bandpowers (Nfreqs,)
    Ninv: np.ndarray           # (Nfreqs,) diag, (Nfreqs, Nfreqs), or scalar
    out_dir: Optional[Path] = None
    flags_tf: Optional[np.ndarray] = None  # (Ntimes, Nfreqs) bool — opt-in
    # per-time flag patterns (True = flagged); when set, the runner uses the
    # grouped time-flags path (models/tflags.py) instead of the w collapse


@dataclass
class RunResult:
    antpair: tuple
    chain: int
    signal_ps: np.ndarray      # (Niter, Nfreqs)
    ln_post: np.ndarray        # (Niter,)
    chisq: np.ndarray
    signal_cr: Optional[np.ndarray]
    fg_amps: Optional[np.ndarray]
    signal_S: np.ndarray
    out_dir: Optional[Path]
    write_time: float = 0.0   # THIS chain's write seconds (the reference's
    # per-baseline write_time, pspec.py:625-638, gathered into timings.json)


# operator-tree fields shared across the batch (replicated on the mesh)
_SHARED_FIELDS = {
    "real": ("f", "igt"),
    "complex": ("fourier_op",),
}


def _split_ops(ops_b, engine):
    names = _SHARED_FIELDS[engine]
    shared = {k: getattr(ops_b, k) for k in names}
    body = ops_b._replace(**{k: None for k in names})
    return body, shared


def _initial_ps_host(S_initial, nfreqs):
    """ps-state from an initial covariance, host-side numpy (see
    models/gibbs.initial_ps for the convention)."""
    S0 = np.asarray(S_initial)
    if S0.ndim == 1:
        return np.clip(S0.real, 0.0, None)
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    ps = np.diagonal(F @ S0 @ F.conj().T).real / nfreqs**2 * nfreqs**2
    return np.clip(ps, 0.0, None)


def run_baselines(
    jobs: Sequence[BaselineJob],
    ps_prior: np.ndarray,
    niter: int,
    *,
    seed: Optional[int] = None,
    nchains: int = 1,
    write_niter: int = 100,
    map_estimate: bool = False,
    store_cr: bool = True,
    jitter: float = 0.0,
    dtype=None,
    engine: str = "auto",
    solver: str = "auto",
    use_mesh: bool = True,
    mesh_devices: Optional[Sequence] = None,
    checkpoint: bool = True,
    checkpoint_niter: int = 0,
    resume: bool = False,
    run_dir: Optional[Path] = None,
    process_id: int = 0,
    num_processes: int = 1,
    n_global_baselines: Optional[int] = None,
    global_baseline_ids: Optional[Sequence[int]] = None,
    verbose: bool = False,
    profile_dir: Optional[str] = None,
):
    """Run Gibbs chains for every (baseline, chain) pair; returns
    ``(results, timings)`` with one :class:`RunResult` per pair.

    ``checkpoint_niter``: checkpoint cadence in iterations (rounded up to
    whole ``write_niter`` chunks); 0 = checkpoint every chunk.
    ``run_dir``: where checkpoint.npz lives (defaults to the parent of the
    first baseline's out_dir — the run's results directory).

    Multi-process (``num_processes > 1``, after jax.distributed init):
    ``jobs`` is this process's local block (reference block rule,
    run-hydra-pspec.py:268-287), ``global_baseline_ids`` its global indices
    (for PRNG streams), ``n_global_baselines`` the global total. Local
    blocks are padded to equal per-process slot counts and assembled into
    globally-sharded arrays via jax.make_array_from_process_local_data —
    the equivalent of the reference's comm.scatter. No collectives run during sampling; each
    process writes only its own baselines' outputs."""
    if map_estimate:
        niter = 1
        write_niter = 1
    engine = device.select_engine(engine)
    device.check_solver(solver)
    if any(j.flags_tf is not None for j in jobs):
        return _run_baselines_tflags(
            jobs, ps_prior, niter, seed=seed, nchains=nchains,
            write_niter=write_niter, map_estimate=map_estimate,
            store_cr=store_cr, jitter=jitter, engine=engine, solver=solver,
            verbose=verbose, global_baseline_ids=global_baseline_ids,
            use_mesh=use_mesh, mesh_devices=mesh_devices,
            run_dir=run_dir, checkpoint=checkpoint, resume=resume,
            process_id=process_id, num_processes=num_processes,
        )
    nbl = len(jobs)
    nfreqs = jobs[0].d.shape[-1]
    meta = [(ib, ic) for ib in range(nbl) for ic in range(nchains)]
    if run_dir is None and jobs[0].out_dir is not None:
        run_dir = Path(jobs[0].out_dir).parent

    prior = jnp.asarray(np.asarray(ps_prior, dtype=np.float64))
    prior_idx = np.nonzero(np.any(np.asarray(ps_prior) > 0, axis=0))[0]
    prior_idx_j = jnp.asarray(prior_idx) if prior_idx.size else None

    base_key = jax.random.key(seed if seed is not None else 0)

    # --- build + stack chain constants ----------------------------------
    ps0_list = [
        _initial_ps_host(job.S_initial, nfreqs) for job in jobs
    ]
    if engine == "real":
        ops_list = [
            rgibbs.build_chain_operators(job.d, job.w, job.fgmodes, job.Ninv)
            for job in jobs
        ]
        ops_b = rgibbs.stack_chain_operators(
            [ops_list[ib] for ib, _ in meta]
        )
        ps_b = jnp.asarray(
            np.stack([ps0_list[ib] for ib, _ in meta]), dtype=jnp.float32
        )
        prior = prior.astype(jnp.float32)
    else:
        ops_list = [
            gcr.build_chain_operators(job.d, job.w, job.fgmodes, job.Ninv,
                                      dtype=dtype)
            for job in jobs
        ]
        stacked = jax.tree.map(
            lambda *xs: jnp.stack(xs), *[ops_list[ib] for ib, _ in meta]
        )
        ops_b = stacked._replace(fourier_op=ops_list[0].fourier_op)
        ps_b = jnp.asarray(np.stack([ps0_list[ib] for ib, _ in meta]))

    # PRNG streams are keyed by the *global* baseline index so multi-process
    # runs reproduce the single-process chains exactly.
    gids = (list(global_baseline_ids) if global_baseline_ids is not None
            else list(range(nbl)))
    keys_b = jnp.stack(
        [
            jax.random.fold_in(jax.random.fold_in(base_key, gids[ib]), ic)
            for ib, ic in meta
        ]
    )
    # Global chain stream ids for the real engine: each (baseline, chain)
    # pair's randomness depends only on this id, never on batch position.
    sid_b = jnp.asarray(
        np.asarray([gids[ib] * nchains + ic for ib, ic in meta],
                   dtype=np.int32))

    # --- pad + shard the batch over the device mesh ---------------------
    # The mesh always engages: a batch not divisible by the device count is
    # padded with dummy chains (copies of element 0) whose outputs are
    # dropped on the host (pmesh.pad_batch contract).
    n_real = len(meta)
    multiproc = num_processes > 1
    local_pad = 0  # dummy slots appended to THIS process's block
    dev_mesh = None
    t_scatter0 = time.perf_counter()
    if multiproc:
        ndev = len(jax.devices())  # global device count
        bpad = ppart.padded_baseline_slots(
            n_global_baselines if n_global_baselines is not None else nbl,
            num_processes, ndev, nchains,
        )
        slots = (bpad // num_processes) * nchains
        pad = local_pad = slots - n_real
        # typed PRNG keys can't cross the host/numpy boundary — ship raw
        # key data and re-wrap after global assembly
        keys_b = jax.random.key_data(keys_b)
        if pad:

            def _pad(x):
                return jnp.concatenate(
                    [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0
                )

            body, shared = _split_ops(ops_b, engine)
            ops_b = jax.tree.map(_pad, body)._replace(**shared)
            ps_b = _pad(ps_b)
            keys_b = _pad(keys_b)
            sid_b = _pad(sid_b)
        dev_mesh = pmesh.make_mesh()
        body, shared = _split_ops(ops_b, engine)
        body = pmesh.host_local_to_global(body, dev_mesh)
        shared = pmesh.replicated_to_global(shared, dev_mesh)
        ops_b = body._replace(**shared)
        ps_b = pmesh.host_local_to_global(ps_b, dev_mesh)
        sid_b = pmesh.host_local_to_global(sid_b, dev_mesh)
        keys_b = jax.random.wrap_key_data(
            pmesh.host_local_to_global(keys_b, dev_mesh)
        )
    elif use_mesh and len(mesh_devices or jax.devices()) > 1:
        dev_mesh = pmesh.make_mesh(mesh_devices)
        nsh = len(dev_mesh.devices.flat)
        n_padded = pmesh.pad_batch(n_real, nsh)
        if n_padded != n_real:
            pad = local_pad = n_padded - n_real

            def _pad(x):
                return jnp.concatenate(
                    [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])], axis=0
                )

            body, shared = _split_ops(ops_b, engine)
            ops_b = jax.tree.map(_pad, body)._replace(**shared)
            ps_b = _pad(ps_b)
            keys_b = _pad(keys_b)
            sid_b = _pad(sid_b)
        body, shared = _split_ops(ops_b, engine)
        body = pmesh.shard_batch(body, dev_mesh)
        rep = pmesh.replicated_sharding(dev_mesh)
        shared = jax.tree.map(lambda x: jax.device_put(x, rep), shared)
        ops_b = body._replace(**shared)
        ps_b = pmesh.shard_batch(ps_b, dev_mesh)
        keys_b = pmesh.shard_batch(keys_b, dev_mesh)
        sid_b = pmesh.shard_batch(sid_b, dev_mesh)
    # Staging is async; block so t_scatter measures real transfer time
    # (reference timers: run-hydra-pspec.py:485-486).
    jax.block_until_ready((ps_b, keys_b))
    jax.block_until_ready([x for x in jax.tree.leaves(ops_b) if x is not None])
    t_scatter = time.perf_counter() - t_scatter0

    # --- per-chunk step functions ---------------------------------------
    if engine == "real":
        def run_chunk(chunk_key_base, ps, n):
            # one key per chunk; rgibbs folds per-iteration internally
            return rgibbs.run_chain_jit(
                chunk_key_base, ops_b, ps, prior, niter=n,
                map_estimate=map_estimate, jitter=jitter, store_cr=store_cr,
                prior_idx=prior_idx_j, solver=solver, sids=sid_b,
            )
        # outputs: (niter, B, ...) — scan-major
        batch_axis = 1
    else:
        axes = jax.tree.map(lambda _: 0, ops_b)._replace(fourier_op=None)
        vchain = jax.jit(
            jax.vmap(
                gibbs.run_chain,
                in_axes=(0, axes, 0, None, None, None, None, None, None),
            ),
            static_argnums=(4, 5, 6, 7),
        )

        def run_chunk(chunk_keys, ps, n):
            return vchain(
                chunk_keys, ops_b, ps, prior, n, map_estimate, jitter,
                store_cr, prior_idx_j,
            )
        # outputs: (B, niter, ...) — vmap-major
        batch_axis = 0

    # --- resume ----------------------------------------------------------
    # A resumed run must end with COMPLETE output files: the pre-checkpoint
    # samples are reloaded from disk and prepended to every flush/collect,
    # and the checkpoint lives at the run level (run_dir), not under any
    # baseline's chain dir.
    start_iter = 0
    prefix = None
    ck_tag = f"-p{process_id}" if multiproc else ""
    if resume and run_dir is not None:
        ck = hio.load_checkpoint(run_dir, tag=ck_tag)
        if ck is not None:
            consistent = (
                ck["ps"].shape == (n_real, nfreqs)
                and ck["extra"].get("engine", engine) == engine
                and ck["extra"].get("nchains", nchains) == nchains
            )
            if consistent:
                prefix = _load_prefix(
                    jobs, meta, nchains, ck["iteration"], store_cr
                )
            if prefix is not None:
                start_iter = ck["iteration"]
                ckps = jnp.asarray(ck["ps"], dtype=ps_b.dtype)
                # pad to this PROCESS's slot count (ps_b is the padded
                # GLOBAL batch in a multi-process run while the checkpoint
                # holds only the local n_real rows — r2 bug)
                npad = (local_pad if multiproc
                        else ps_b.shape[0] - n_real)
                if npad:
                    ckps = jnp.concatenate(
                        [ckps,
                         jnp.broadcast_to(ckps[:1],
                                          (npad, ckps.shape[1]))], 0
                    )
                if multiproc:
                    ps_b = pmesh.host_local_to_global(np.asarray(ckps), dev_mesh)
                else:
                    ps_b = jax.device_put(ckps, ps_b.sharding)
                if verbose:
                    print(f"resuming from iteration {start_iter}")
            elif verbose:
                print(
                    "checkpoint inconsistent with this run's jobs/outputs; "
                    "starting fresh"
                )

    # --- chunked scan with host flushes ---------------------------------
    host_chunks = []
    write_time = 0.0
    writer = None
    if jobs[0].out_dir is not None:
        from .utils.fastio import AsyncNpyWriter

        writer = AsyncNpyWriter()  # native pool; falls back to np.save
    ckpt_every = max(1, -(-checkpoint_niter // write_niter)) \
        if checkpoint_niter > 0 else 1
    n_chunks = 0
    # per-(baseline, chain) write seconds — the reference records the true
    # per-baseline write time and gathers it across ranks
    # (run-hydra-pspec.py:554-557); with the async writer, pool IO seconds
    # are attributed to rows proportional to bytes submitted per chunk
    row_write_sec = [0.0] * len(meta)
    t0_proc = time.perf_counter()
    done = start_iter

    def _process_chunk(samples, ps_ck, done_ck):
        """Fetch one chunk's samples, flush, and checkpoint AT THAT chunk's
        state (``ps_ck``/``done_ck``) — called after the NEXT chunk has
        already been dispatched, so the device-to-host transfer and disk
        writes overlap with the next chunk's execution (the reference's
        write-every-write_Niter loop is serial, pspec.py:625-638)."""
        nonlocal n_chunks, write_time
        host_chunks.append(
            _to_host(samples, engine, store_cr, batch_axis, n_real))
        n_chunks += 1
        if verbose:
            hc = host_chunks[-1]
            lnp_last = np.take(hc.ln_post, -1, axis=1 - batch_axis)
            print(
                f"iter {done_ck}/{niter}  "
                f"chisq={float(np.mean(hc.chisq)):.4f}  "
                f"ln_post={float(np.mean(lnp_last)):.1f}"
            )
        t0 = time.perf_counter()
        if jobs[0].out_dir is not None:
            io0 = writer.write_seconds() if writer is not None else 0.0
            row_bytes = [0] * len(meta)
            _flush(jobs, meta, host_chunks, batch_axis, nchains, store_cr,
                   nfreqs, prefix, writer,
                   row_sec=row_write_sec, row_bytes=row_bytes)
            # durability ordering: all sample files on disk BEFORE the
            # checkpoint records `done_ck`
            if writer is not None:
                failed = writer.wait()
                if failed:
                    raise IOError(f"{failed} async sample writes failed")
                pool_sec = writer.write_seconds() - io0
                total_bytes = sum(row_bytes)
                if pool_sec > 0 and total_bytes > 0:
                    for i, b in enumerate(row_bytes):
                        row_write_sec[i] += pool_sec * b / total_bytes
            if checkpoint and run_dir is not None and (
                n_chunks % ckpt_every == 0 or done_ck >= niter
            ):
                ps_host = (pmesh.global_to_host_local(ps_ck) if multiproc
                           else np.asarray(jax.device_get(ps_ck)))
                hio.save_checkpoint(
                    run_dir,
                    iteration=done_ck,
                    ps=ps_host[:n_real],
                    key_data=jax.random.key_data(base_key),
                    extra={"niter": niter, "engine": engine,
                           "nchains": nchains},
                    tag=ck_tag,
                )
        write_time += time.perf_counter() - t0

    # --profile_dir: capture a jax.profiler trace of ONE steady-state chunk
    # (the second, so compilation is excluded; the first when only one
    # chunk exists) — the SURVEY §5.1 tracing-tier equivalent.
    n_total_chunks = max(1, -(-(niter - start_iter) // write_niter))
    profile_chunk = None if profile_dir is None else min(1, n_total_chunks - 1)
    chunk_idx = 0
    pending = None
    while done < niter:
        n = min(write_niter, niter - done)
        profiling = chunk_idx == profile_chunk
        if profiling:
            jax.profiler.start_trace(str(profile_dir))
        if engine == "real":
            chunk_key = jax.random.fold_in(base_key, 1_000_000 + done)
            ps_b, samples = run_chunk(chunk_key, ps_b, n)
        else:
            chunk_keys = jax.vmap(lambda k: jax.random.fold_in(k, done))(keys_b)
            ps_b, samples = run_chunk(chunk_keys, ps_b, n)
        if profiling:
            jax.block_until_ready(ps_b)
            jax.profiler.stop_trace()
        done += n
        chunk_idx += 1
        if pending is not None:
            # previous chunk: fetched/flushed while this one executes
            _process_chunk(*pending)
        pending = (samples, ps_b, done)
    if pending is not None:
        _process_chunk(*pending)
    if writer is not None:
        writer.close()
    t_process = time.perf_counter() - t0_proc

    results = _collect(
        jobs, meta, host_chunks, batch_axis, nchains, store_cr, nfreqs,
        row_write_sec, prefix
    )
    timings = {
        "process": t_process,
        "write": write_time,
        "scatter": t_scatter,
        "niter": niter,
        "start_iter": start_iter,
        "batch": len(meta),
        "engine": engine,
    }
    return results, timings


class _HostSample:
    __slots__ = ("signal_cr", "ps", "fg_amps", "chisq", "ln_post")

    def __init__(self, signal_cr, ps, fg_amps, chisq, ln_post):
        self.signal_cr = signal_cr
        self.ps = ps
        self.fg_amps = fg_amps
        self.chisq = chisq
        self.ln_post = ln_post


def _trim(arr, batch_axis, n_real):
    """Drop mesh-padding dummy chains (batch axis beyond n_real)."""
    if arr is None or arr.ndim <= batch_axis or arr.shape[batch_axis] == n_real:
        return arr
    sl = [slice(None)] * arr.ndim
    sl[batch_axis] = slice(0, n_real)
    return arr[tuple(sl)]


def _host(a, batch_axis):
    """Device array -> this process's numpy block (whole array when fully
    addressable; assembled local shards in a multi-process run)."""
    if a is None:
        return None
    if hasattr(a, "is_fully_addressable") and not a.is_fully_addressable:
        return pmesh.global_to_host_local(a, batch_axis)
    return np.asarray(a)


def _to_host(samples, engine, store_cr, batch_axis, n_real):
    h = lambda a: _host(a, batch_axis)
    if engine == "real":
        cr = (h(samples.signal_cr.re) + 1j * h(samples.signal_cr.im)
              if store_cr else None)
        fga = (h(samples.fg_amps.re) + 1j * h(samples.fg_amps.im)
               if store_cr else None)
    else:
        cr = h(samples.signal_cr) if store_cr else None
        fga = h(samples.fg_amps) if store_cr else None
    t = lambda a: _trim(a, batch_axis, n_real)
    return _HostSample(
        t(cr),
        t(h(samples.ps)),
        t(fga),
        t(h(samples.chisq)),
        t(h(samples.ln_post)),
    )


def _chain_dir(out_dir, chain, nchains):
    d = Path(out_dir)
    if nchains > 1:
        d = d / f"chain-{chain}"
    return d


def _take(arr, idx, batch_axis):
    if arr is None:
        return None
    return np.take(arr, idx, axis=batch_axis)


def _slice_batch(host_chunks, idx, batch_axis, store_cr, prefix=None):
    """Per-(baseline, chain) arrays with iterations on axis 0;
    ``prefix`` (resume) holds this chain's pre-checkpoint samples reloaded
    from disk, prepended so a resumed run yields complete files."""
    pre = prefix or {}

    def cat(key, chunk_arrs):
        parts = ([pre[key]] if key in pre else []) + chunk_arrs
        return np.concatenate(parts)

    ps = cat("signal_ps", [_take(c.ps, idx, batch_axis) for c in host_chunks])
    lnp = cat("ln_post", [
        np.atleast_1d(_take(c.ln_post, idx, batch_axis)) for c in host_chunks
    ])
    if store_cr:
        cr = cat("signal_cr",
                 [_take(c.signal_cr, idx, batch_axis) for c in host_chunks])
        fga = cat("fg_amps",
                  [_take(c.fg_amps, idx, batch_axis) for c in host_chunks])
        chi = cat("chisq",
                  [_take(c.chisq, idx, batch_axis) for c in host_chunks])
    else:
        cr = fga = None
        chi = cat("chisq", [
            np.atleast_1d(_take(c.chisq, idx, batch_axis)) for c in host_chunks
        ])
    return ps, lnp, cr, fga, chi


def _load_prefix(jobs, meta, nchains, start_iter, store_cr):
    """Reload each chain's first ``start_iter`` samples from its output
    directory for resume. Returns a list (one dict per batch index) or None
    when any chain's files are missing/short — in which case the caller
    starts from scratch rather than producing corrupt output."""
    if start_iter == 0:
        return None
    keys = ["signal_ps", "ln_post"] + (
        ["signal_cr", "fg_amps", "chisq"] if store_cr else ["chisq"]
    )
    prefix = []
    for ib, ic in meta:
        if jobs[ib].out_dir is None:
            return None
        s = hio.load_samples(_chain_dir(jobs[ib].out_dir, ic, nchains))
        if any(k not in s or s[k].shape[0] < start_iter for k in keys):
            return None
        prefix.append({k: s[k][:start_iter] for k in keys})
    return prefix


def _final_S(ps_last, nfreqs):
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    return F.conj().T @ np.diag(ps_last / nfreqs**2).astype(complex) @ F


def _flush(jobs, meta, host_chunks, batch_axis, nchains, store_cr, nfreqs,
           prefix=None, writer=None, row_sec=None, row_bytes=None):
    """Write every row's sample files. ``row_sec``/``row_bytes`` (optional
    lists of len(meta)) accumulate per-row host write seconds and bytes
    submitted — the per-baseline write accounting the reference gathers
    into timings.json (run-hydra-pspec.py:554-557); with the async writer
    the pool's IO seconds are attributed afterwards by the caller
    (proportional to bytes)."""
    for bidx, (ib, ic) in enumerate(meta):
        job = jobs[ib]
        if job.out_dir is None:
            continue
        t0 = time.perf_counter()
        ps, lnp, cr, fga, chi = _slice_batch(
            host_chunks, bidx, batch_axis, store_cr,
            prefix[bidx] if prefix else None)
        d = _chain_dir(job.out_dir, ic, nchains)
        arrays = (
            cr if cr is not None else np.zeros(0),
            _final_S(ps[-1], nfreqs),
            ps,
            fga if fga is not None else np.zeros(0),
            chi,
            lnp,
        )
        hio.write_numpy_files(d, *arrays, writer=writer)
        if row_sec is not None:
            row_sec[bidx] += time.perf_counter() - t0
        if row_bytes is not None:
            row_bytes[bidx] += sum(np.asarray(a).nbytes for a in arrays)


def _collect(jobs, meta, host_chunks, batch_axis, nchains, store_cr, nfreqs,
             row_write_sec, prefix=None):
    """``row_write_sec``: per-(baseline, chain) write seconds (list aligned
    with ``meta``) or a scalar applied to every row."""
    results = []
    for bidx, (ib, ic) in enumerate(meta):
        job = jobs[ib]
        ps, lnp, cr, fga, chi = _slice_batch(
            host_chunks, bidx, batch_axis, store_cr,
            prefix[bidx] if prefix else None)
        wt = (row_write_sec[bidx] if isinstance(row_write_sec, (list, tuple))
              else row_write_sec)
        results.append(
            RunResult(
                antpair=job.antpair,
                chain=ic,
                signal_ps=ps,
                ln_post=lnp,
                chisq=chi,
                signal_cr=cr,
                fg_amps=fga,
                signal_S=_final_S(ps[-1], nfreqs),
                out_dir=None if job.out_dir is None
                else _chain_dir(job.out_dir, ic, nchains),
                write_time=wt,
            )
        )
    return results


def _run_tflags_real_batched(jobs, flags_of, prior64, prior_idx_j, niter,
                             base_key, *, nchains, write_niter,
                             map_estimate, store_cr, jitter, solver,
                             verbose=False, global_baseline_ids=None,
                             use_mesh=True, mesh_devices=None,
                             run_dir=None, checkpoint=True, resume=False,
                             process_id=0, num_processes=1):
    """Batched tflags execution: one batched (baseline x chain) run
    per flag signature. Within a signature the per-time-group operators
    are stacked across rows (rgibbs.stack_chain_operators, same machinery
    as the plain path), and randomness is keyed on global stream ids
    sid = ib * nchains + ic — so results are bit-identical whether
    baselines run together or one at a time (tested in
    tests/test_tflags.py).

    Multi-process runs execute each process's local block on its LOCAL
    devices only: tflags signature groups can differ per process, so a
    global mesh would desynchronize the SPMD program across processes.
    Baselines are independent and streams are keyed on global ids, so
    per-host local execution is bit-identical to a single-process run
    (tested in tests/test_multihost.py::test_tflags_two_process)."""
    from .models import tflags

    if num_processes > 1:
        # process-local compute: each host's block on its own devices
        mesh_devices = jax.local_devices()
    nbl = len(jobs)
    # group job indices by flag signature (identical arrays => identical
    # time-group structure and per-group channel weights)
    sig_order, sig_members = [], {}
    for ib, job in enumerate(jobs):
        f = flags_of(job)
        sig = (f.shape, f.tobytes())
        if sig not in sig_members:
            sig_members[sig] = []
            sig_order.append(sig)
        sig_members[sig].append(ib)

    prior_j = jnp.asarray(prior64, dtype=jnp.float32)
    if run_dir is None and jobs[0].out_dir is not None:
        run_dir = Path(jobs[0].out_dir).parent
    results_by_row = {}
    start_iters = []
    write_time = 0.0
    t0_proc = time.perf_counter()
    for sig in sig_order:
        ibs = sig_members[sig]
        meta_g = [(ib, ic) for ib in ibs for ic in range(nchains)]
        per_bl = {
            ib: tflags.build_grouped_operators_real(
                jobs[ib].d, flags_of(jobs[ib]), jobs[ib].fgmodes,
                jobs[ib].Ninv,
            )
            for ib in ibs
        }
        first = per_bl[ibs[0]]
        groups = [
            tflags.TimeGroupReal(
                ops=rgibbs.stack_chain_operators(
                    [per_bl[ib][g].ops for ib, _ in meta_g]
                ),
                idx=first[g].idx,
            )
            for g in range(len(first))
        ]
        nfreqs = jobs[ibs[0]].d.shape[-1]
        gids = (list(global_baseline_ids)
                if global_baseline_ids is not None else list(range(nbl)))
        sid_host = np.asarray(
            [gids[ib] * nchains + ic for ib, ic in meta_g], dtype=np.int32)
        ps_host0 = np.stack([
            _initial_ps_host(jobs[ib].S_initial, nfreqs)
            for ib, _ in meta_g
        ]).astype(np.float32)
        n_rows = len(meta_g)
        mesh_on = use_mesh and len(mesh_devices or jax.devices()) > 1
        dev_mesh = pmesh.make_mesh(mesh_devices) if mesh_on else None
        nsh = len(dev_mesh.devices.flat) if mesh_on else 1
        # pad the CHAIN batch to the shard count (same pad + shard_batch
        # contract as the plain path: dummy rows broadcast from row 0 and
        # dropped on the host; sids keep the dummy rows' streams harmless
        # copies of row 0's).
        pad = pmesh.pad_batch(n_rows, nsh) - n_rows if mesh_on else 0
        if pad:
            def _pad(x):
                return jnp.concatenate(
                    [x, jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])],
                    axis=0)
            groups = [
                g._replace(ops=jax.tree.map(
                    _pad, g.ops._replace(f=None, igt=None)
                )._replace(f=g.ops.f, igt=g.ops.igt))
                for g in groups
            ]
            sid_host = np.concatenate(
                [sid_host, np.repeat(sid_host[:1], pad)])
            ps_host0 = np.concatenate(
                [ps_host0, np.repeat(ps_host0[:1], pad, axis=0)])

        # pooled-conditional CDF table at alpha + 1 = TOTAL times (each
        # group's own igt carries its group's alpha — wrong shape for
        # the pooled prior-bin draw; see tflags.gibbs_step_tflags_real)
        from .ops.invgamma import make_invgamma_table

        igt_tot = make_invgamma_table(
            int(sum(int(g.idx.size) for g in groups)))
        sids = jnp.asarray(sid_host)
        ps_state = jnp.asarray(ps_host0)
        if mesh_on:
            rep = pmesh.replicated_sharding(dev_mesh)
            groups = [
                g._replace(ops=pmesh.shard_batch(
                    g.ops._replace(f=None, igt=None), dev_mesh
                )._replace(
                    f=jax.device_put(g.ops.f, rep),
                    igt=jax.tree.map(
                        lambda x: jax.device_put(x, rep), g.ops.igt),
                ))
                for g in groups
            ]
            ps_state = pmesh.shard_batch(ps_state, dev_mesh)
            sids = pmesh.shard_batch(sids, dev_mesh)
            igt_tot = jax.tree.map(
                lambda x: jax.device_put(x, rep), igt_tot)

        @partial(jax.jit, static_argnames=("n",))
        def chunk_fn(key, ps, n, _groups=groups, _sids=sids,
                     _igt=igt_tot):
            return tflags.run_chain_tflags_real(
                key, _groups, ps, prior_j, n, map_estimate=map_estimate,
                jitter=jitter, store_cr=store_cr, prior_idx=prior_idx_j,
                solver=solver, sids=_sids, igt_total=_igt,
            )

        # --- resume (per-signature checkpoint tag: signature groups run
        # sequentially, so each carries its own iteration cursor) --------
        start_iter = 0
        prefix = None
        ck_tag = (f"-tf{sig_order.index(sig)}"
                  + (f"-p{process_id}" if num_processes > 1 else ""))
        if resume and run_dir is not None:
            ck = hio.load_checkpoint(run_dir, tag=ck_tag)
            if ck is not None and (
                ck["ps"].shape == (n_rows, nfreqs)
                and ck["extra"].get("engine", "real") == "real"
                and ck["extra"].get("nchains", nchains) == nchains
            ):
                prefix = _load_prefix(
                    jobs, meta_g, nchains, ck["iteration"], store_cr
                )
                if prefix is not None:
                    start_iter = ck["iteration"]
                    x = jnp.asarray(ck["ps"], dtype=jnp.float32)
                    if pad:
                        x = jnp.concatenate(
                            [x, jnp.broadcast_to(x[:1], (pad, nfreqs))], 0)
                    ps_state = jax.device_put(x, ps_state.sharding)
                    if verbose:
                        print(f"[tflags] resuming group {ck_tag} from "
                              f"iteration {start_iter}")
        start_iters.append(start_iter)

        host_chunks = []
        row_write_sec = [0.0] * len(meta_g)
        done = start_iter
        while done < niter:
            n = min(write_niter, niter - done)
            chunk_key = jax.random.fold_in(base_key, 1_000_000 + done)
            ps_state, samples = chunk_fn(chunk_key, ps_state, n)
            host_chunks.append(
                _to_host(samples, "real", store_cr, 1, n_rows)
            )
            done += n
            if verbose:
                hc = host_chunks[-1]
                print(f"[tflags x{len(ibs)} baselines] iter {done}/{niter}"
                      f"  chisq={float(np.mean(hc.chisq)):.4f}")
            if jobs[0].out_dir is not None:
                t0 = time.perf_counter()
                _flush(jobs, meta_g, host_chunks, 1, nchains, store_cr,
                       nfreqs, prefix, row_sec=row_write_sec)
                write_time += time.perf_counter() - t0
                if checkpoint and run_dir is not None:
                    hio.save_checkpoint(
                        run_dir, iteration=done, ps=_host(ps_state, 0)[:n_rows],
                        key_data=jax.random.key_data(base_key),
                        extra={"engine": "real", "nchains": nchains,
                               "tflags": True},
                        tag=ck_tag,
                    )

        for row, (ib, ic) in enumerate(meta_g):
            job = jobs[ib]
            ps, lnp, cr, fga, chi = _slice_batch(
                host_chunks, row, 1, store_cr,
                prefix[row] if prefix else None,
            )
            d = (None if job.out_dir is None
                 else _chain_dir(job.out_dir, ic, nchains))
            results_by_row[(ib, ic)] = RunResult(
                antpair=job.antpair, chain=ic, signal_ps=ps, ln_post=lnp,
                chisq=chi, signal_cr=cr, fg_amps=fga,
                signal_S=_final_S(ps[-1], nfreqs), out_dir=d,
                write_time=row_write_sec[row],
            )
    results = [results_by_row[(ib, ic)]
               for ib in range(nbl) for ic in range(nchains)]
    timings = {
        "process": time.perf_counter() - t0_proc,
        "write": write_time,
        "scatter": 0.0,
        "niter": niter,
        "start_iter": min(start_iters) if start_iters else 0,
        "batch": nbl * nchains,
        "engine": "real",
    }
    return results, timings


def _run_baselines_tflags(jobs, ps_prior, niter, *, seed, nchains,
                          write_niter, map_estimate, store_cr, jitter,
                          engine, solver, verbose=False,
                          global_baseline_ids=None, use_mesh=True,
                          mesh_devices=None, run_dir=None, checkpoint=True,
                          resume=False, process_id=0, num_processes=1):
    """Grouped time-dependent-flags path (models/tflags.py). On the real
    engine, baselines sharing a flag SIGNATURE — identical
    (Ntimes, Nfreqs) flag arrays, hence identical time-group structure —
    are batched into one (baseline x chain) run with per-row
    composition-invariant PRNG streams (sids), so the replicated scaling
    fixture and real arrays with a common RFI mask scale like the plain
    path instead of a per-baseline Python loop. Distinct signatures run as
    separate batched groups. The complex engine keeps the per-baseline
    loop (x64 correctness tier). The reference collapses time-dependent
    flags entirely (run-hydra-pspec.py:541 FIXME)."""
    from .models import tflags

    prior64 = np.asarray(ps_prior, dtype=np.float64)
    prior_idx = np.nonzero(np.any(prior64 > 0, axis=0))[0]
    prior_idx_j = jnp.asarray(prior_idx) if prior_idx.size else None
    base_key = jax.random.key(seed if seed is not None else 0)

    def _flags_of(job):
        return (np.asarray(job.flags_tf, dtype=bool)
                if job.flags_tf is not None
                else np.zeros(job.d.shape, dtype=bool))

    if engine == "real":
        return _run_tflags_real_batched(
            jobs, _flags_of, prior64, prior_idx_j, niter, base_key,
            nchains=nchains, write_niter=write_niter,
            map_estimate=map_estimate, store_cr=store_cr, jitter=jitter,
            solver=solver, verbose=verbose,
            global_baseline_ids=global_baseline_ids, use_mesh=use_mesh,
            mesh_devices=mesh_devices, run_dir=run_dir,
            checkpoint=checkpoint, resume=resume,
            process_id=process_id, num_processes=num_processes,
        )
    if num_processes > 1:
        raise NotImplementedError(
            "time_flags with num_processes > 1 runs on the real engine "
            "(per-host local execution); the complex x64 parity engine is "
            "single-process only"
        )

    results = []
    write_time = 0.0
    t0_proc = time.perf_counter()
    for ib, job in enumerate(jobs):
        nfreqs = job.d.shape[-1]
        flags_tf = _flags_of(job)
        ps0 = _initial_ps_host(job.S_initial, nfreqs)
        groups = tflags.build_grouped_operators(
            job.d, flags_tf, job.fgmodes, job.Ninv
        )
        prior_j = jnp.asarray(prior64)
        ps_state = jnp.broadcast_to(jnp.asarray(ps0), (nchains, nfreqs))
        chain_keys = jnp.stack([
            jax.random.fold_in(jax.random.fold_in(base_key, ib), ic)
            for ic in range(nchains)
        ])

        @partial(jax.jit, static_argnames=("n",))
        def chunk_fn(keys, ps, n, _groups=groups, _prior=prior_j):
            return jax.vmap(
                lambda k, p: tflags.run_chain_tflags(
                    k, _groups, p, _prior, n, map_estimate=map_estimate,
                    jitter=jitter, store_cr=store_cr,
                    prior_idx=prior_idx_j,
                )
            )(keys, ps)
        batch_axis = 0

        host_chunks = []
        done = 0
        while done < niter:
            n = min(write_niter, niter - done)
            keys = jax.vmap(lambda k: jax.random.fold_in(k, done))(chain_keys)
            ps_state, samples = chunk_fn(keys, ps_state, n)
            host_chunks.append(
                _to_host(samples, engine, store_cr, batch_axis, nchains)
            )
            done += n
            if verbose:
                hc = host_chunks[-1]
                print(f"[tflags {job.antpair}] iter {done}/{niter}  "
                      f"chisq={float(np.mean(hc.chisq)):.4f}")

        for ic in range(nchains):
            ps, lnp, cr, fga, chi = _slice_batch(
                host_chunks, ic, batch_axis, store_cr
            )
            d = (None if job.out_dir is None
                 else _chain_dir(job.out_dir, ic, nchains))
            row_write = 0.0
            if d is not None:
                t0 = time.perf_counter()
                hio.write_numpy_files(
                    d,
                    cr if cr is not None else np.zeros(0),
                    _final_S(ps[-1], nfreqs),
                    ps,
                    fga if fga is not None else np.zeros(0),
                    chi,
                    lnp,
                )
                row_write = time.perf_counter() - t0
                write_time += row_write
            # per-result write seconds are THIS row's own delta (the
            # reference's per-baseline write_data semantics,
            # run-hydra-pspec.py:554-557), not the running total — the
            # batched path's row_write_sec convention
            results.append(RunResult(
                antpair=job.antpair, chain=ic, signal_ps=ps, ln_post=lnp,
                chisq=chi, signal_cr=cr, fg_amps=fga,
                signal_S=_final_S(ps[-1], nfreqs), out_dir=d,
                write_time=row_write,
            ))
    timings = {
        "process": time.perf_counter() - t0_proc,
        "write": write_time,
        "scatter": 0.0,
        "niter": niter,
        "start_iter": 0,
        "batch": len(jobs) * nchains,
        "engine": engine,
    }
    return results, timings


def gelman_rubin(ps_chains: np.ndarray) -> np.ndarray:
    """Split-R-hat convergence diagnostic over chains: input
    (Nchains, Niter, Nfreqs) bandpower samples, output (Nfreqs,). New
    capability enabled by cheap multi-chain batching (BASELINE.json calls
    for cross-host collectives only for convergence diagnostics)."""
    c, n, k = ps_chains.shape
    half = n // 2
    splits = ps_chains[:, :half], ps_chains[:, half : 2 * half]
    x = np.concatenate(splits, axis=0)  # (2c, half, k)
    nn = x.shape[1]
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    B = nn * chain_means.var(axis=0, ddof=1)
    W = chain_vars.mean(axis=0)
    var_hat = (nn - 1) / nn * W + B / nn
    return np.sqrt(var_hat / np.maximum(W, 1e-300))
