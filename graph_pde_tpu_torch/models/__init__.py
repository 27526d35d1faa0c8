from .gkn import GKNConfig, gkn_init, gkn_apply, gkn_apply_batched, params_to
from .gcn import GCNConfig, gcn_init, gcn_apply, gcn_apply_batched
from .mgkn_general import (MGKNGeneralConfig, mgkn_general_init,
                           mgkn_general_apply, mgkn_general_apply_batched)
from .mgkn_orthogonal import (MultipoleGraph1D, MGKNOrthogonalConfig,
                              mgkn_orthogonal_init, mgkn_orthogonal_apply,
                              mgkn_orthogonal_apply_batched, multipole_batch)

__all__ = ["GKNConfig", "gkn_init", "gkn_apply", "gkn_apply_batched",
           "params_to", "GCNConfig", "gcn_init", "gcn_apply",
           "gcn_apply_batched", "MGKNGeneralConfig", "mgkn_general_init",
           "mgkn_general_apply", "mgkn_general_apply_batched",
           "MultipoleGraph1D", "MGKNOrthogonalConfig",
           "mgkn_orthogonal_init", "mgkn_orthogonal_apply",
           "mgkn_orthogonal_apply_batched", "multipole_batch"]
