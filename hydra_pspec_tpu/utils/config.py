"""Run configuration: accepts the reference's YAML config keys
(test_data/config.yaml, scripts/3bl-example/config-3bl-mpi.yaml) plus CLI
overrides, with the reference's per-baseline ``--X`` / ``--X_file``
resolution convention (run-hydra-pspec.py:248-266)."""
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Optional

import numpy as np

from .. import device

# keys earlier versions accepted for a kernel this version removed
_REMOVED_KEYS = ("warm_ns", "drift_max")


@dataclass
class RunConfig:
    """Mirrors the reference's ~25 driver flags (run-hydra-pspec.py:39-239).
    Knobs the reference does not have are grouped at the bottom."""

    file_paths: list = field(default_factory=list)
    ant_str: str = "cross"
    sigcov0: Optional[str] = None
    sigcov0_file: Optional[str] = None
    Nfgmodes: int = 8
    fgmodes: Optional[str] = None
    fgmodes_file: Optional[str] = None
    freq_range: Optional[str] = None
    flags: Optional[str] = None
    flags_file: Optional[str] = None
    noise: Optional[str] = None
    noise_file: Optional[str] = None
    noise_cov: Optional[str] = None
    noise_cov_file: Optional[str] = None
    nsamples: Optional[str] = None
    nsamples_file: Optional[str] = None
    n_ps_prior_bins: int = 3
    ps_prior_lo: float = 0.0
    ps_prior_hi: float = 0.0
    map_estimate: bool = False
    Niter: int = 100
    seed: Optional[int] = None
    verbose: bool = False
    Nproc: int = 1            # accepted for config parity; unused (no pools)
    out_dir: str = "./"
    dirname: Optional[str] = None
    clobber: bool = False
    write_Niter: int = 100
    # --- extensions -----------------------------------------------------
    nchains: int = 1          # independent Gibbs chains per baseline
    time_flags: bool = False  # per-time flag patterns (reference FIXME :541)
    precision: str = "auto"   # "auto" | "x32" | "x64"; auto: x64 on the
                              # CPU (parity), x32 on an accelerator
    store_cr: bool = True     # materialize per-iteration signal CRs
    resume: bool = False      # resume from checkpoint.npz if present
    checkpoint_Niter: int = 0  # 0 = checkpoint every write_Niter
    jitter: float = 0.0       # Cholesky diagonal jitter (f32 robustness)
    engine: str = "auto"      # "auto" | "real" (f32 pairs) | "complex"
                              # (x64 parity); auto = complex under x64,
                              # real otherwise
    solver: str = "auto"      # "auto" | "chol" | "recinv" (real engine)
    profile_dir: Optional[str] = None  # capture a jax.profiler trace of one
                              # sampling chunk into this directory (the
                              # SURVEY §5.1 tracing-tier equivalent)

    def __post_init__(self):
        device.check_engine(self.engine)
        device.check_solver(self.solver)
        device.check_precision(self.precision)

    @classmethod
    def from_yaml(cls, path, **overrides):
        """Needs ``pyyaml``, imported here so that the rest of the package
        runs without it."""
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, base_dir=Path(path).parent, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, base_dir=None, **overrides):
        removed = sorted(set(raw) & set(_REMOVED_KEYS))
        if removed:
            raise ValueError(
                f"Config keys {removed} were removed with the kernel they "
                "tuned; delete them")
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        merged = {**raw, **{k: v for k, v in overrides.items() if v is not None}}
        cfg = cls(**merged)
        if base_dir is not None:
            # The reference resolves config-relative paths from the CWD of
            # the run (test_data/README.md runs from within test_data/);
            # we resolve relative to the config file, which is stricter.
            for attr in ("sigcov0", "fgmodes", "flags", "noise", "noise_cov", "nsamples"):
                v = getattr(cfg, attr)
                if v and not Path(v).is_absolute():
                    setattr(cfg, attr, str(Path(base_dir) / v))
            cfg.file_paths = [
                str(p if Path(p).is_absolute() else Path(base_dir) / p)
                for p in cfg.file_paths
            ]
            if not Path(cfg.out_dir).is_absolute():
                cfg.out_dir = str(Path(base_dir) / cfg.out_dir)
        return cfg

    def to_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def check_load_path(fp):
    """File-or-directory resolution (reference run-hydra-pspec.py:248-266):
    returns ``(is_dir, data)`` — data loaded when ``fp`` is a file."""
    fp = Path(fp)
    if fp.is_dir():
        return True, None
    return False, np.load(fp)


def resolve_per_baseline(path, per_file, bl_str, default_name=None):
    """Resolve a per-baseline aux input: ``path`` may be a single file
    (shared by all baselines) or a directory containing
    ``<ant1>-<ant2>/<per_file>`` (reference convention,
    run-hydra-pspec.py:379-391).

    Compatibility fallback: when ``path`` names a non-existent file but
    ``<parent>/<bl_str>/<filename>`` exists, that per-baseline file is used
    — the reference's bundled test_data/config.yaml points at
    ``./noise.npy`` etc. while the files actually live in ``0-1/``."""
    if path is None:
        return None
    p = Path(path)
    if not p.exists():
        alt = p.parent / bl_str / p.name
        if alt.exists():
            return np.load(alt)
    is_dir, data = check_load_path(p)
    if not is_dir:
        return data
    name = per_file or default_name
    if name is None:
        raise ValueError(f"Need a filename for per-baseline directory {path}")
    return np.load(p / bl_str / name)
