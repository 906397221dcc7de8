"""Attention ops and the hand-written Hopper kernels' wrappers."""

from unionml_tpu_torch.ops.attention import dot_product_attention, multihead_attention
from unionml_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_backward_dkv,
    flash_backward_dkv_reference,
    flash_backward_dq,
    flash_backward_dq_reference,
    flash_forward,
    flash_forward_reference,
)
from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

__all__ = [
    "dot_product_attention",
    "flash_attention",
    "flash_backward_dkv",
    "flash_backward_dkv_reference",
    "flash_backward_dq",
    "flash_backward_dq_reference",
    "flash_forward",
    "flash_forward_reference",
    "multihead_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
]
