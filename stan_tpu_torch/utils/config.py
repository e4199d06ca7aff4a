# Copied from stan_tpu/utils/config.py; the port keeps its own copy.
"""Typed run configuration: TOML file + CLI overrides.

The reference's entire config system is the serialized ``Analysis`` object
(src/STAN_Database/Analysis.cs:8-25) edited in the GUI (BOX_Analysis) and
partially overridden at launch (MainWindow.xaml.cs:444-446); the solver
itself takes no flags (Solver.cs:24). This module supersets that: a typed
``RunConfig`` whose [analysis] section round-trips into the STdb
``Analysis`` record for reference parity, plus [mesh], [sharding],
[inference], and [logging] sections the reference has no counterpart for.

Load order (later wins): dataclass defaults < TOML file < CLI overrides.

Example TOML::

    [analysis]
    type = "Linear_Statics"     # | "Nonlinear_Statics"
    solver = "CG"               # | "Cholesky" | "LU"
    tolerance = 1e-6
    maxiter = 0                 # 0 = automatic (ndof cap)
    increments = 1

    [mesh]
    integration = "G2"          # G1 reduced / G2 full, per element family

    [sharding]
    domain = 4                  # device-mesh extent of the DOF/domain axis
    chains = 2                  # device-mesh extent of the chains axis

    [inference]
    sampler = "nuts"            # | "hmc" | "vi" | "smc"
    chains = 8
    warmup = 500
    samples = 1000
    sigma_obs = 1e-5
    seed = 0

    [logging]
    json = "run.jsonl"          # structured per-phase record (utils/runlog)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from stan_tpu_torch.core.model import AnalysisSettings


@dataclasses.dataclass
class AnalysisConfig:
    type: str = "Linear_Statics"
    solver: str = "CG"
    tolerance: float = 1.0e-6
    maxiter: int = 0
    increments: int = 1


@dataclasses.dataclass
class MeshConfig:
    integration: str = "G2"  # quadrature choice pushed to elements


@dataclasses.dataclass
class ShardingConfig:
    domain: int = 1   # devices along the DOF/domain-decomposition axis
    chains: int = 1   # devices along the chain/particle axis


@dataclasses.dataclass
class InferenceConfig:
    sampler: str = "nuts"
    chains: int = 8
    warmup: int = 500
    samples: int = 1000
    sigma_obs: float = 1.0e-5
    seed: int = 0
    infer_load: bool = False


@dataclasses.dataclass
class LoggingConfig:
    json: Optional[str] = None  # path for the structured run record


@dataclasses.dataclass
class RunConfig:
    analysis: AnalysisConfig = dataclasses.field(default_factory=AnalysisConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
    inference: InferenceConfig = dataclasses.field(
        default_factory=InferenceConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)

    def to_analysis_settings(self) -> AnalysisSettings:
        """The STdb-persisted subset (reference Analysis.cs fields)."""
        return AnalysisSettings(
            type=self.analysis.type,
            lin_solver=self.analysis.solver,
            lin_solver_tolerance=self.analysis.tolerance,
            lin_solver_maxiter=self.analysis.maxiter,
            inc_numb=self.analysis.increments,
        )

    def apply_to_model(self, model) -> None:
        """Push the analysis + mesh sections onto a loaded FEModel."""
        model.analysis = self.to_analysis_settings()
        fam = {"G1": "HEX8_G1", "G2": "HEX8_G2"}.get(self.mesh.integration)
        if fam is not None and model.nelem and model.conn.shape[1] == 8:
            model.set_formulation(fam)


_SECTIONS = {
    "analysis": AnalysisConfig,
    "mesh": MeshConfig,
    "sharding": ShardingConfig,
    "inference": InferenceConfig,
    "logging": LoggingConfig,
}


class ConfigError(ValueError):
    pass


def load(path: Optional[str] = None, overrides: Optional[dict] = None
         ) -> RunConfig:
    """Build a RunConfig from defaults, an optional TOML file, and
    ``overrides`` of the form {"analysis.solver": "Cholesky", ...}.

    Unknown sections/keys are refused (typos fail loudly, §5.3 of the
    survey: validate-and-refuse rather than silently ignore)."""
    cfg = RunConfig()
    if path is not None:
        import tomllib

        with open(path, "rb") as fh:
            data = tomllib.load(fh)
        for section, values in data.items():
            if section not in _SECTIONS:
                raise ConfigError(f"unknown config section [{section}]")
            target = getattr(cfg, section)
            for key, val in values.items():
                if not hasattr(target, key):
                    raise ConfigError(
                        f"unknown key '{key}' in section [{section}]")
                setattr(target, key, val)
    for dotted, val in (overrides or {}).items():
        if val is None:
            continue
        section, _, key = dotted.partition(".")
        if section not in _SECTIONS or not hasattr(getattr(cfg, section), key):
            raise ConfigError(f"unknown override '{dotted}'")
        setattr(getattr(cfg, section), key, val)
    _validate(cfg)
    return cfg


def _validate(cfg: RunConfig) -> None:
    a = cfg.analysis
    if a.type not in ("Linear_Statics", "Nonlinear_Statics"):
        raise ConfigError(f"analysis.type: {a.type!r}")
    if a.solver not in ("CG", "Cholesky", "LU"):
        raise ConfigError(f"analysis.solver: {a.solver!r}")
    if not (a.tolerance > 0):
        raise ConfigError("analysis.tolerance must be > 0")
    if a.maxiter < 0 or a.increments < 1:
        raise ConfigError("analysis.maxiter >= 0, increments >= 1 required")
    if cfg.mesh.integration not in ("G1", "G2"):
        raise ConfigError(f"mesh.integration: {cfg.mesh.integration!r}")
    if cfg.sharding.domain < 1 or cfg.sharding.chains < 1:
        raise ConfigError("sharding extents must be >= 1")
    if cfg.inference.sampler not in ("hmc", "nuts", "vi", "smc"):
        raise ConfigError(f"inference.sampler: {cfg.inference.sampler!r}")
