from .normalizers import (UnitGaussianNormalizer, GaussianNormalizer,
                          RangeNormalizer)
from .losses import LpLoss, l1_loss, mse_loss

__all__ = ["UnitGaussianNormalizer", "GaussianNormalizer", "RangeNormalizer",
           "LpLoss", "l1_loss", "mse_loss"]
