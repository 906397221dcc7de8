"""Attention ops and the hand-written Hopper kernels' wrappers."""

from unionml_tpu_torch.ops.attention import dot_product_attention, multihead_attention
from unionml_tpu_torch.ops.paged_attention import paged_decode_attention, paged_decode_attention_reference

__all__ = [
    "dot_product_attention",
    "multihead_attention",
    "paged_decode_attention",
    "paged_decode_attention_reference",
]
