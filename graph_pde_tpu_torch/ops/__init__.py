from .dense import (linear_init, pyg_uniform_init, dense_init, dense_apply,
                    dense_sin_apply, layer_dims)
from .segment import (masked_segment_sum, masked_segment_mean,
                      segment_counts, segment_degrees, gather_rows)
from .edge_conv import edge_kernel_conv, edge_conv_gaussian
from .fused_edge_conv import (fused_edge_messages, edge_messages_plain,
                              fused_path_supported)
from .fused_iterate import (fused_iterate_total, fused_iterate_total_plain,
                            sorted_iterate_setup, fused_iterate_supported)
from .cached_contraction import (apply_cached_kernel, maybe_quantize_k,
                                 quantize_ste, to_fp8, cached_contraction,
                                 cached_contraction_plain,
                                 cached_contraction_bwd,
                                 cached_contraction_bwd_plain,
                                 contraction_supported)

__all__ = [
    "linear_init", "pyg_uniform_init", "dense_init", "dense_apply",
    "dense_sin_apply", "layer_dims", "masked_segment_sum", "masked_segment_mean",
    "segment_counts", "segment_degrees", "gather_rows", "edge_kernel_conv",
    "edge_conv_gaussian",
    "fused_edge_messages", "edge_messages_plain", "fused_path_supported",
    "fused_iterate_total", "fused_iterate_total_plain",
    "sorted_iterate_setup", "fused_iterate_supported",
    "apply_cached_kernel", "maybe_quantize_k", "quantize_ste", "to_fp8",
    "cached_contraction", "cached_contraction_plain",
    "cached_contraction_bwd", "cached_contraction_bwd_plain",
    "contraction_supported",
]
