"""The radix prefix cache and the static shared prefix of the port, held
against the JAX package on the CPU.

The JAX package's own cases run here against the port (see
``test_torch_serving_units.py``), their fixtures port builds of the same
shapes: all of ``tests/unit/test_prefix_cache.py`` (the tree ring over the
port's copy of ``prefix_cache.py``, the engine ring over its
``ContinuousBatcher``) and the prefix cases of ``test_generate.py``,
``test_speculative.py`` and ``test_structured.py``. Then the same inputs go
through both packages: ``Generator(..., prefix=...)`` and ``stream`` (plain,
``prefill_chunk``, int8 KV, grammars, a draft) give the JAX package's greedy
tokens, and ``gather_paged_rows`` returns exactly the rows that were
scattered in, for float and int8 pools. Tiny f32 models; tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_continuous import _models
from tests.test_torch_serving_units import generator, port_cases, tiny_llama

torch.set_num_threads(2)

port_cases(globals(), "test_prefix_cache.py")

#: the unit files build ``Generator(module, params, cfg)``: the port's
#: Generator over a port model, on the CPU
Generator = generator  # noqa: F811


@pytest.fixture(scope="module")
def tiny_gen():
    return tiny_llama(97, seed=0), None


@pytest.fixture(scope="module")
def tiny():
    model = tiny_llama(97, seed=0)
    return model, None, model.config


def _port_speculative(target, tp, draft, dp, config, gamma=4):
    """The JAX ``SpeculativeGenerator(target, params, draft, params, ...)``
    call shape over the port's."""
    from unionml_tpu_torch.models import SpeculativeGenerator

    return SpeculativeGenerator(target, draft, config, gamma=gamma, device="cpu")


def _spec_model(seed: int, n_layers: int = 2, dim: int = 64):
    """``test_speculative.py``'s ``_model`` as a port build."""
    from unionml_tpu_torch.models import Llama, LlamaConfig

    config = LlamaConfig.tiny(vocab_size=97, dim=dim, n_layers=n_layers, n_heads=4, n_kv_heads=2,
                              hidden_dim=2 * dim, dtype=torch.float32, param_dtype=torch.float32)
    return Llama(config, device="cpu", seed=seed), None


def _draft_pair(tiny):
    """``test_structured.py``'s draft: the target's shape, other weights."""
    return tiny_llama(97, seed=7), None


def _unit_cases(name: str, cases, **overrides) -> None:
    """Bring ``cases`` of ``tests/unit/<name>`` into this module, their
    globals pointed at the port and at ``overrides``."""
    namespace: dict = {}
    port_cases(namespace, name)
    namespace.update(overrides)
    for case in cases:
        globals()[case] = namespace[case]


_unit_cases(
    "test_generate.py",
    ("test_prefix_cache_matches_full_prompt", "test_prefix_cache_stream_matches_call",
     "test_prefix_cache_with_chunked_prefill_and_int8_kv", "test_prefix_cache_rejects_empty_suffix"),
    Generator=generator,
)
_unit_cases("test_speculative.py", ("test_speculative_with_prefix_is_exact",), Generator=generator,
            _model=_spec_model, SpeculativeGenerator=_port_speculative)
_unit_cases("test_structured.py",
            ("test_prefix_cache_composes_with_constraint", "test_speculative_constrained_composes_with_prefix"),
            Generator=generator, _draft_pair=_draft_pair)


@pytest.fixture(scope="module")
def cs():
    """The structured cases' grammar set, over the port's compiler."""
    from unionml_tpu_torch.models import ConstraintSet, compile_regex

    texts = _texts()
    return ConstraintSet([compile_regex(r"[a-c]{3,5}", texts, eos_id=96),
                          compile_regex(r"-?[0-9]+(\.[0-9]+)?", texts, eos_id=96)])


def _texts():
    """``test_structured.py``'s token texts: ids 1-26 a-z, 27-36 digits,
    three multi-character pieces, the rest empty."""
    texts = [""] * 97
    for i in range(26):
        texts[1 + i] = chr(ord("a") + i)
    for i in range(10):
        texts[27 + i] = str(i)
    texts[40], texts[41], texts[42] = "ab", "12", "3.5"
    return texts


# ----------------------------------------------------------------- both packages


def test_radix_module_is_the_jax_module_below_its_docstring():
    """The port's ``prefix_cache.py`` is a copy: its code equals the JAX
    module's from the first import on (only the module docstring differs)."""
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent

    def code(package):
        text = (root / package / "serving" / "prefix_cache.py").read_text()
        return text[text.index("from __future__"):]

    assert code("unionml_tpu_torch") == code("unionml_tpu")


@pytest.fixture(scope="module")
def pair():
    return _models(dict(vocab_size=97, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128))


@pytest.fixture(scope="module")
def draft_pair():
    return _models(dict(vocab_size=97, dim=32, n_layers=1, n_heads=4, n_kv_heads=2, hidden_dim=64), seed=9)


PREFIX = [11, 12, 13, 4, 5, 6, 7, 8, 9, 10, 21]
SUFFIXES = [[3, 1, 4], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [8]]
GENERATOR_CASES = {
    "plain": {},
    "prefill-chunk": dict(prefill_chunk=4),
    "int8-kv-prefill-chunk": dict(kv_cache_dtype="int8", prefill_chunk=4),
    "grammars": dict(eos_id=96),
    "draft-grammars": dict(eos_id=96),
}


@pytest.mark.parametrize("case", list(GENERATOR_CASES))
def test_generator_prefix_tokens_equal_jax(pair, draft_pair, case):
    """``Generator(...)(suffixes, prefix=...)`` and its ``stream`` give the
    JAX Generator's greedy tokens, which are those of the full prompts."""
    from unionml_tpu import models as jax_models
    from unionml_tpu_torch import models as port

    module, params, model, _ = pair
    kw = dict(max_new_tokens=7, temperature=0.0, prompt_buckets=(8, 16), **GENERATOR_CASES[case])
    jax_kw, port_kw, call = dict(kw), dict(kw), {}
    if "grammars" in case:
        texts = _texts()
        jax_kw["constraints"] = jax_models.ConstraintSet([jax_models.compile_regex(r"[a-c]{3,5}", texts, eos_id=96)])
        port_kw["constraints"] = port.ConstraintSet([port.compile_regex(r"[a-c]{3,5}", texts, eos_id=96)])
        call = dict(constraint=[1, 0, 1])
    if case.startswith("draft"):
        d_module, d_params, d_model, _ = draft_pair
        jax_kw["draft"] = jax_models.DraftSpec(module=d_module, params=d_params, gamma=3)
        port_kw["draft"] = port.DraftSpec(module=d_model, gamma=3)
    jax_gen = jax_models.Generator(module, params, jax_models.GenerationConfig(**jax_kw))
    gen = port.Generator(model, port.GenerationConfig(**port_kw), device="cpu")
    prefix = gen.cache_prefix(PREFIX)
    assert prefix.length == len(PREFIX) and prefix.tokens == tuple(PREFIX)
    ref = np.asarray(jax_gen(SUFFIXES, prefix=jax_gen.cache_prefix(PREFIX), **call))
    out = gen(SUFFIXES, prefix=prefix, **call)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, gen([PREFIX + s for s in SUFFIXES], **call))
    chunks = list(gen.stream(SUFFIXES, prefix=prefix, chunk_size=3, **call))
    for i, row in enumerate(out):
        got = np.concatenate([np.asarray(c[i]).ravel() for c in chunks])
        np.testing.assert_array_equal(got, row[: len(got)])
    if case.startswith("draft"):
        spec = gen._speculative()
        assert spec.draft_prefix(prefix) is spec.draft_prefix(prefix)  # memoized per PrefixCache
    with pytest.raises(ValueError, match="non-empty"):
        gen([[1], []], prefix=prefix)


@pytest.mark.parametrize("kv", [None, "int8"], ids=["f32-pool", "int8-pool"])
def test_gather_paged_rows_returns_the_scattered_rows(pair, kv):
    """The engine's admission scatter then ``gather_paged_rows`` through the
    same table is the identity on every leaf (the int8 pools' scale planes
    too), bit for bit, for rows whose tables share leading blocks."""
    from unionml_tpu_torch.models import init_cache, init_paged_cache
    from unionml_tpu_torch.models.generate import gather_paged_rows
    from unionml_tpu_torch.serving import ContinuousBatcher

    _, _, model, _ = pair
    cfg = model.config
    block, max_blocks, n_blocks, width = 4, 6, 12, 24
    pool = init_paged_cache(cfg, 2, n_blocks + 1, block, max_blocks, kv_dtype=kv, fill_block=n_blocks, device="cpu")
    g = torch.Generator().manual_seed(3)
    rows = []
    for slot, blocks in enumerate(([0, 1, 2, 3, 4, 5], [0, 1, 7, 8, 9, 10])):
        row = init_cache(cfg, 1, width, kv_dtype=kv, device="cpu")
        for layer in row:
            for name, t in layer.items():
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=g, dtype=torch.int8))
                else:
                    t.copy_(torch.rand(t.shape, generator=g))
        if slot:  # the second row shares the first two blocks: their rows are the first row's
            for layer, first in zip(row, rows[0][1]):
                for name in layer:
                    layer[name][:, : 2 * block] = first[name][:, : 2 * block]
        tok, lengths, done = torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool)
        ContinuousBatcher._paged_admit_impl(pool, row, tok, lengths, done, slot, tok[:1], lengths[:1],
                                            np.asarray(blocks, np.int32), 2 if slot else 0)
        rows.append((blocks, row))
    for blocks, row in rows:
        gathered = gather_paged_rows(pool, np.asarray(blocks, np.int32), width)
        for got, want in zip(gathered, row):
            assert set(got) == set(want) == ({"k", "v", "k_scale", "v_scale"} if kv else {"k", "v"})
            for name in want:
                assert got[name].dtype == want[name].dtype
                assert torch.equal(got[name], want[name]), name
