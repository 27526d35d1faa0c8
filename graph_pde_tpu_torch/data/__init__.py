from .synthetic import (grf_2d, solve_darcy_2d, darcy_sample, darcy_dataset,
                        grf_1d, solve_burgers_1d, burgers_dataset)
from .datasets import (load_or_generate_darcy, load_or_generate_burgers,
                       DarcyArrays, prepare_darcy, darcy_gkn_graphs,
                       darcy_mgkn_graphs, BurgersArrays, prepare_burgers,
                       burgers_gkn_graphs, burgers_multipole_data,
                       batch_iterator, prefetch_to_device)

__all__ = ["grf_2d", "solve_darcy_2d", "darcy_sample", "darcy_dataset",
           "grf_1d", "solve_burgers_1d", "burgers_dataset",
           "load_or_generate_darcy", "load_or_generate_burgers",
           "DarcyArrays", "prepare_darcy", "darcy_gkn_graphs",
           "darcy_mgkn_graphs", "BurgersArrays", "prepare_burgers",
           "burgers_gkn_graphs", "burgers_multipole_data", "batch_iterator",
           "prefetch_to_device"]
