from .torch_import import (load_torch_module, convert_kernelnn,
                           load_reference_kernelnn)

__all__ = ["load_torch_module", "convert_kernelnn",
           "load_reference_kernelnn"]
