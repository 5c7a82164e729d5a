"""Core algorithm of the port: quantization, sparsification, error
feedback, Eq. 4 scales and the per-client protocol (the FSFL compression
and scaling pipeline, port of ``repro.core``)."""
from repro_torch.core.delta import (CompressionConfig, compress_delta,
                                    delta_levels, ternary_compress)
from repro_torch.core.quant import QuantConfig, dequantize, quantize
from repro_torch.core.residual import apply_error_feedback, zeros_like_tree
from repro_torch.core.scaling import apply_scale, init_scales, scale_mask
from repro_torch.core.sparsify import SparsifyConfig, sparsify_tree

__all__ = [
    "CompressionConfig", "compress_delta", "delta_levels", "ternary_compress",
    "QuantConfig", "quantize", "dequantize",
    "apply_error_feedback", "zeros_like_tree",
    "apply_scale", "init_scales", "scale_mask",
    "SparsifyConfig", "sparsify_tree",
]
