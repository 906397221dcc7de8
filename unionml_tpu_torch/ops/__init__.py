"""Attention, int8 quantization and the hand-written Hopper kernels' wrappers."""

from unionml_tpu_torch.ops.attention import dot_product_attention, multihead_attention
from unionml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_backward,
    flash_backward_dkv_reference,
    flash_backward_dq_reference,
    flash_backward_f32,
    flash_backward_reference,
    flash_forward,
    flash_forward_f32,
    flash_forward_reference,
)
from unionml_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_reference, quantized_matmul
from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference
from unionml_tpu_torch.ops.quant import (
    QuantizedKernel,
    QuantizedTensor,
    dequantize,
    dequantize_tree,
    quantize_array,
    quantize_params,
)

__all__ = [
    "QuantizedKernel",
    "QuantizedTensor",
    "dequantize",
    "dequantize_tree",
    "dot_product_attention",
    "flash_attention",
    "flash_backward",
    "flash_backward_dkv_reference",
    "flash_backward_dq_reference",
    "flash_backward_f32",
    "flash_backward_reference",
    "flash_forward",
    "flash_forward_f32",
    "flash_forward_reference",
    "int8_matmul",
    "int8_matmul_reference",
    "multihead_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
    "quantize_array",
    "quantize_params",
    "quantized_matmul",
]
