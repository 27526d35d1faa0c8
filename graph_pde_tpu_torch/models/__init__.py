from .gkn import GKNConfig, gkn_init, gkn_apply, gkn_apply_batched, params_to

__all__ = ["GKNConfig", "gkn_init", "gkn_apply", "gkn_apply_batched",
           "params_to"]
