from .registry import ExperimentConfig, register, get, names
from .runners import run_experiment
from .sweeps import REFERENCE_SWEEPS, sweep_configs, run_sweep

__all__ = ["ExperimentConfig", "register", "get", "names",
           "run_experiment", "REFERENCE_SWEEPS", "sweep_configs",
           "run_sweep"]
