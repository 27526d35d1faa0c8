from .synthetic import grf_2d, solve_darcy_2d, darcy_sample, darcy_dataset

__all__ = ["grf_2d", "solve_darcy_2d", "darcy_sample", "darcy_dataset"]
