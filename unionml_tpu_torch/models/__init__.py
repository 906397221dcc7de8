"""Model library: the Llama decoder, its layers, the weight bridge and generation."""

from unionml_tpu_torch.models.convert import (
    llama_from_jax,
    llama_params_from_jax,
    llama_params_to_numpy,
    state_dict_from_jax,
)
from unionml_tpu_torch.models.generate import (
    GenerationConfig,
    Generator,
    chunk_aligned,
    filtered_logits,
    init_cache,
    init_paged_cache,
    policy_probs,
    sample_tokens,
)
from unionml_tpu_torch.models.llama import (
    Llama,
    LlamaConfig,
    causal_lm_loss,
    chunked_causal_lm_loss,
    lora_optimizer,
    lora_param_labels,
)

__all__ = [
    "GenerationConfig",
    "Generator",
    "Llama",
    "LlamaConfig",
    "causal_lm_loss",
    "chunk_aligned",
    "chunked_causal_lm_loss",
    "filtered_logits",
    "init_cache",
    "init_paged_cache",
    "llama_from_jax",
    "llama_params_from_jax",
    "llama_params_to_numpy",
    "lora_optimizer",
    "lora_param_labels",
    "policy_probs",
    "sample_tokens",
    "state_dict_from_jax",
]
