from .synthetic import grf_2d, solve_darcy_2d, darcy_sample, darcy_dataset
from .datasets import (load_or_generate_darcy, DarcyArrays, prepare_darcy,
                       darcy_gkn_graphs, batch_iterator)

__all__ = ["grf_2d", "solve_darcy_2d", "darcy_sample", "darcy_dataset",
           "load_or_generate_darcy", "DarcyArrays", "prepare_darcy",
           "darcy_gkn_graphs", "batch_iterator"]
