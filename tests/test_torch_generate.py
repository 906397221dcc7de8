"""Parity of the port's ``Generator`` and sampling policy with the JAX
package's, on a tiny f32 Llama on the CPU.

Greedy decoding must be token-identical (dense and int8 KV, chunked
prefill, int8 weights on the plain route, and under the serve CLI's env
knobs). Sampled decoding is held on the distribution —
``filtered_logits``/``policy_probs`` within 1e-6 — because ``jax.random`` and
``torch.Generator`` draw different numbers from one seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.models.generate import filtered_logits as jax_filtered_logits
from unionml_tpu.models.generate import policy_probs as jax_policy_probs
from unionml_tpu_torch.ops.quant import QuantizedKernel
from unionml_tpu_torch.models import (
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    filtered_logits,
    llama_params_from_jax,
    policy_probs,
)

torch.set_num_threads(2)

SHAPE = dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
#: wide enough that quantize="int8" (min_size 65536) takes q/o, the MLP and
#: the head, and leaves k/v (256 x 128) in float
INT8_SHAPE = dict(vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=512)
PROMPTS = [[3, 14, 15, 92, 6], [27, 1], [8, 2, 8, 1, 8, 2, 8]]


def _pair(shape):
    jax_cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **shape)
    module = JaxLlama(jax_cfg)
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **shape)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module, params, model


@pytest.fixture(scope="module")
def pair():
    return _pair(SHAPE)


@pytest.fixture(scope="module")
def int8_pair():
    """A float port model that the first ``Generator(quantize="int8")``
    quantizes in place; later ones find it int8 already."""
    return _pair(INT8_SHAPE)


@pytest.mark.parametrize("case", ["dense", "int8-kv", "eos", "prefill-chunk"])
def test_greedy_tokens_match_jax(pair, case):
    module, params, model = pair
    kw = dict(max_new_tokens=10, temperature=0.0, prompt_buckets=(16,))
    if case == "int8-kv":
        kw["kv_cache_dtype"] = "int8"
    if case == "prefill-chunk":  # bucket 16 prefilled through the cache in 4 chunks
        kw["prefill_chunk"] = 4
    ref = np.asarray(JaxGenerator(module, params, JaxGenerationConfig(**kw))(PROMPTS))
    if case == "eos":  # an id the first stream emits mid-way: pads follow it
        kw.update(eos_id=int(ref[0, 3]), pad_id=0)
        ref = np.asarray(JaxGenerator(module, params, JaxGenerationConfig(**kw))(PROMPTS))
    out = Generator(model, GenerationConfig(**kw), device="cpu")(PROMPTS)
    assert out.dtype == np.int32 and out.shape == (len(PROMPTS), 10)
    np.testing.assert_array_equal(out, ref)


def test_stream_yields_the_call_tokens(pair):
    _, _, model = pair
    gen = Generator(model, GenerationConfig(max_new_tokens=9, temperature=0.0, prompt_buckets=(16,)), device="cpu")
    chunks = list(gen.stream(PROMPTS, chunk_size=3))
    assert [c.shape[1] for c in chunks] == [1, 3, 3, 2]
    np.testing.assert_array_equal(np.concatenate(chunks, axis=1), gen(PROMPTS))


def test_sampled_decoding_is_seeded(pair):
    _, _, model = pair
    gen = Generator(model, GenerationConfig(max_new_tokens=6, temperature=1.0, top_k=10, prompt_buckets=(16,)),
                    device="cpu")
    a, b = gen(PROMPTS, seed=3), gen(PROMPTS, seed=3)
    np.testing.assert_array_equal(a, b)
    assert ((0 <= a) & (a < SHAPE["vocab_size"])).all()


POLICIES = {
    "greedy": dict(temperature=0.0),
    "top_k": dict(temperature=1.0, top_k=5),
    "top_p": dict(temperature=0.8, top_p=0.8),
    "min_p": dict(temperature=1.2, min_p=0.1),
    "all": dict(temperature=0.7, top_k=20, top_p=0.9, min_p=0.05),
}


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_distribution_matches_jax(name):
    logits = (np.random.RandomState(7).randn(3, 97) * 3).astype(np.float32)
    jax_cfg = JaxGenerationConfig(**POLICIES[name])
    cfg = GenerationConfig(**POLICIES[name])
    probs = policy_probs(torch.from_numpy(logits), cfg)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jax_policy_probs(jnp.asarray(logits), jax_cfg)), atol=1e-6, rtol=0)
    if cfg.temperature > 0.0:
        ref = np.asarray(jax_filtered_logits(jnp.asarray(logits), jax_cfg))
        port = filtered_logits(torch.from_numpy(logits), cfg).numpy()
        np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
        kept = ~np.isneginf(ref)
        np.testing.assert_allclose(port[kept], ref[kept], atol=1e-6, rtol=0)


@pytest.mark.parametrize(
    "option",
    ["mesh", "sp_prefill"],
)
def test_unported_options_raise(pair, option):
    """The mesh path and sp_prefill are ported (tests/test_torch_generate_tp.py).
    What is still refused: a mesh that is not a built ``Mesh``, and an
    sp_prefill that names no sequence-parallel attention."""
    _, _, model = pair
    cfg, kw = GenerationConfig(), {}
    if option == "mesh":
        kw[option] = object()
        err, match = TypeError, "MeshSpec"
    else:
        cfg = dataclasses.replace(cfg, sp_prefill="rings")
        err, match = ValueError, "sp_prefill"
    with pytest.raises(err, match=match):
        Generator(model, cfg, device="cpu", **kw)


@pytest.mark.parametrize("case", ["int8-weights", "int8-weights-int8-kv", "int8-weights-prefill-chunk"])
def test_int8_greedy_tokens_match_jax(int8_pair, case):
    """``quantize="int8"`` on the plain route dequantizes as the JAX
    package does: greedy f32 tokens are identical."""
    module, params, model = int8_pair
    kw = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    if case.endswith("int8-kv"):
        kw["kv_cache_dtype"] = "int8"
    if case.endswith("prefill-chunk"):
        kw["prefill_chunk"] = 8
    ref = np.asarray(JaxGenerator(module, params, JaxGenerationConfig(**kw), quantize="int8")(PROMPTS))
    gen = Generator(model, GenerationConfig(**kw), device="cpu", quantize="int8")
    assert gen.quantize == "int8"
    assert isinstance(model.layer_0.mlp.wo.kernel, QuantizedKernel)
    assert isinstance(model.layer_0.attn.k_proj.kernel, torch.nn.Parameter)  # below min_size
    np.testing.assert_array_equal(gen(PROMPTS), ref)


def test_serve_env_knobs_are_followed_as_in_jax(int8_pair, pair, monkeypatch, caplog):
    """The serve CLI's exports reach a Generator built with no quantize= and
    no kv_cache_dtype: int8 weights and an int8 cache, in both packages, with
    the same tokens. Garbage values warn and fall back; explicit values win."""
    module, params, model = int8_pair
    monkeypatch.setenv("UNIONML_TPU_QUANTIZE", "int8")
    monkeypatch.setenv("UNIONML_TPU_KV_CACHE_DTYPE", "INT8")
    cfg = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    jax_gen = JaxGenerator(module, params, JaxGenerationConfig(**cfg))
    gen = Generator(model, GenerationConfig(**cfg), device="cpu")
    assert (gen.quantize, gen.config.kv_cache_dtype) == (jax_gen.quantize, jax_gen.config.kv_cache_dtype) == ("int8", "int8")
    np.testing.assert_array_equal(gen(PROMPTS), np.asarray(jax_gen(PROMPTS)))

    _, _, float_model = pair
    monkeypatch.setenv("UNIONML_TPU_QUANTIZE", "fp4")
    monkeypatch.setenv("UNIONML_TPU_KV_CACHE_DTYPE", "none")
    with caplog.at_level("WARNING"):
        gen = Generator(float_model, GenerationConfig(**cfg), device="cpu")
    assert gen.quantize is None and gen.config.kv_cache_dtype is None
    assert "UNIONML_TPU_QUANTIZE" in caplog.text
    monkeypatch.setenv("UNIONML_TPU_KV_CACHE_DTYPE", "int8")
    explicit = Generator(float_model, GenerationConfig(**cfg, kv_cache_dtype=None), device="cpu")
    assert explicit.config.kv_cache_dtype == "int8"  # None means unset, as in JAX
    with pytest.raises(ValueError, match="unsupported quantize mode 'int4'"):
        Generator(float_model, GenerationConfig(**cfg), device="cpu", quantize="int4")
