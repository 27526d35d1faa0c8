from .normalizers import (UnitGaussianNormalizer, GaussianNormalizer,
                          RangeNormalizer)

__all__ = ["UnitGaussianNormalizer", "GaussianNormalizer", "RangeNormalizer"]
