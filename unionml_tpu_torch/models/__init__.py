"""Model library: the Llama decoder, its layers, the weight bridge, generation
and structured (grammar-constrained) decoding."""

from unionml_tpu_torch.models.convert import (
    llama_from_jax,
    llama_params_from_jax,
    llama_params_to_numpy,
    state_dict_from_jax,
)
from unionml_tpu_torch.models.generate import (
    DraftSpec,
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
from unionml_tpu_torch.models.speculative import SpeculativeGenerator
from unionml_tpu_torch.models.structured import (
    ConstraintSet,
    TokenConstraint,
    compile_regex,
    json_object,
    literal_choice,
    stop_sequences,
    vocab_from_tokenizer,
)

__all__ = [
    "ConstraintSet",
    "DraftSpec",
    "GenerationConfig",
    "Generator",
    "Llama",
    "LlamaConfig",
    "TokenConstraint",
    "causal_lm_loss",
    "chunk_aligned",
    "chunked_causal_lm_loss",
    "compile_regex",
    "filtered_logits",
    "init_cache",
    "init_paged_cache",
    "json_object",
    "literal_choice",
    "llama_from_jax",
    "llama_params_from_jax",
    "llama_params_to_numpy",
    "lora_optimizer",
    "lora_param_labels",
    "policy_probs",
    "SpeculativeGenerator",
    "sample_tokens",
    "state_dict_from_jax",
    "stop_sequences",
    "vocab_from_tokenizer",
]
