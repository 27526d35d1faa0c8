from .matio import MatReader, write_mat
from .normalizers import (UnitGaussianNormalizer, GaussianNormalizer,
                          RangeNormalizer)
from .losses import LpLoss, l1_loss, mse_loss
from .filters import gaussian_filter, gaussian_filter1d

__all__ = ["MatReader", "write_mat", "UnitGaussianNormalizer",
           "GaussianNormalizer", "RangeNormalizer", "LpLoss", "l1_loss",
           "mse_loss", "gaussian_filter", "gaussian_filter1d"]
