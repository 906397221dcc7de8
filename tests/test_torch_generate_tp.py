"""Sharded generation over a mesh of gloo ranks: the port's cases of
``tests/emulated/test_generate_tp.py`` that fit in 4 ranks.

One world of 4 ranks (``tests/torch_mesh_ranks.py``) builds the port's
``Generator(mesh=MeshSpec(...).build(device="cpu"), partition_rules=...)``
on weights carried from the JAX trees and runs every case; the parent holds
each rank's greedy f32 tokens equal to JAX's unsharded run AND to JAX's
sharded run at the same mesh shape on 4 of the emulated devices:

- megatron TP and FSDP: ``model=4``, ``data=2 x model=2``, ``data=2 x
  fsdp=2`` (the batch padded to the data axis; a single prompt too; the
  stream's chunks join to the same tokens);
- sequence-parallel prefill: ring at ``sequence=4`` and ulysses at ``data=2 x
  sequence=2``, alone and with ``cache_prefix`` (the prefix prefills
  sequence-parallel, the suffixes through the offset chunked path);
- beam search at ``data=2 x model=2``;
- expert-parallel MoE at ``data=2 x expert=2`` (ample capacity: drop-free
  routing on every path), and MoE at ``data=2 x model=2`` at capacity
  factor 1.25 (tokens drop: the capacity and slots are the global
  batch's); the same MoE under ring prefill at ``sequence=2 x expert=2``
  is refused by both packages with a ``TypeError`` at the first call (the
  JAX package's ``MoEConfig`` takes no ``attention_impl``);
- int8 weights with an int8 KV cache at ``fsdp=2 x model=2``;
- grammar constraints at ``data=2 x model=2``;
- a speculative draft (its own rules) over ``model=4``: ``__call__`` and
  ``stream``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import seeded_params
from tests.torch_mesh_ranks import World, threaded
from unionml_tpu.models import ConstraintSet as JaxConstraintSet, DraftSpec as JaxDraftSpec
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig, compile_regex as jax_compile_regex
from unionml_tpu.models import llama_partition_rules as jax_llama_rules
from unionml_tpu.models.moe import MoEConfig as JaxMoEConfig, MoETransformer as JaxMoETransformer
from unionml_tpu.models.moe import moe_partition_rules as jax_moe_rules
from unionml_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

CONFIGS = {
    "llama": dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128),
    "int8": dict(vocab_size=96, dim=256, n_layers=1, n_heads=8, n_kv_heads=4, hidden_dim=512),
    "moe": dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96, n_experts=4, k=2,
                capacity_factor=8.0),
    "draft": dict(vocab_size=96, dim=64, n_layers=1, n_heads=4, n_kv_heads=4, hidden_dim=64),
    # the default capacity factor: tokens drop, and the capacity is the global batch's
    "moe_tight": dict(vocab_size=64, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=96, n_experts=4, k=2,
                      capacity_factor=1.25),
}
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [7, 1, 8], [2, 8, 1, 8, 2, 8], [4, 6]]
BASE = dict(max_new_tokens=6, temperature=0.0, prompt_buckets=(16,))
PREFIX = [(i * 7) % 90 + 1 for i in range(24)]
SUFFIXES = [[3, 1, 4], [9, 2, 6, 5]]
PREFIX_BASE = dict(max_new_tokens=6, temperature=0.0, prompt_buckets=(8, 32))
TEXTS = [""] * 96
for _i in range(26):
    TEXTS[1 + _i] = chr(ord("a") + _i)
GRAMMAR = (TEXTS, r"[a-c]{2,6}", 95)
GIDS = [1, 0, 1, 0]

CASES = [
    dict(name="tp4", spec=dict(model=4), model="llama", rules="llama", config=BASE, prompts=PROMPTS),
    dict(name="dp2-tp2", spec=dict(data=2, model=2), model="llama", rules="llama", config=BASE, prompts=PROMPTS),
    dict(name="dp2-fsdp2", spec=dict(data=2, fsdp=2), model="llama", rules="llama", config=BASE, prompts=PROMPTS),
    dict(name="ring", spec=dict(sequence=4), model="llama", config={**BASE, "sp_prefill": "ring"}, prompts=PROMPTS),
    dict(name="ulysses", spec=dict(data=2, sequence=2), model="llama", config={**BASE, "sp_prefill": "ulysses"},
         prompts=PROMPTS),
    dict(name="ring-prefix", spec=dict(sequence=4), model="llama", config={**PREFIX_BASE, "sp_prefill": "ring"},
         prompts=SUFFIXES, prefix=PREFIX),
    dict(name="ulysses-prefix", spec=dict(data=2, sequence=2), model="llama",
         config={**PREFIX_BASE, "sp_prefill": "ulysses"}, prompts=SUFFIXES, prefix=PREFIX),
    dict(name="beams", spec=dict(data=2, model=2), model="llama", rules="llama", config=BASE, prompts=PROMPTS[:3],
         beams=4),
    dict(name="moe", spec=dict(data=2, expert=2), model="moe", rules="moe", config=BASE, prompts=PROMPTS),
    dict(name="int8", spec=dict(fsdp=2, model=2), model="int8", rules="llama",
         config={**BASE, "kv_cache_dtype": "int8"}, prompts=PROMPTS, quantize="int8"),
    dict(name="constraints", spec=dict(data=2, model=2), model="llama", rules="llama",
         config={**BASE, "eos_id": 95}, prompts=PROMPTS, grammar=GRAMMAR, constraint=GIDS),
    dict(name="draft", spec=dict(model=4), model="llama", rules="llama", config=BASE, prompts=PROMPTS, draft=True),
    # one prompt alone routes another batch: no single-prompt run
    dict(name="moe-dp2-tight", spec=dict(data=2, model=2), model="moe_tight", rules="moe", config=BASE, prompts=PROMPTS,
         single=False),
    # sequence-parallel prefill of a dropping MoE: the JAX package refuses it
    # at the first call (its MoEConfig takes no attention_impl), and so must
    # the port, with the same exception type
    dict(name="moe-ring-tight", spec=dict(sequence=2, expert=2), model="moe_tight", rules="moe",
         config={**BASE, "sp_prefill": "ring"}, prompts=PROMPTS, single=False, refused="TypeError"),
    # Generator.enable_aot over a mesh: every program captured in segments between its collectives (tapes of
    # aten ops on the CPU), replayed with the collectives run between the graphs
    dict(name="tp4-aot", spec=dict(model=4), model="llama", rules="llama", config=BASE, prompts=PROMPTS, aot=True),
    dict(name="ring-aot", spec=dict(sequence=4), model="llama", config={**BASE, "sp_prefill": "ring"},
         prompts=PROMPTS, aot=True),
    dict(name="moe-ep2-aot", spec=dict(data=2, expert=2), model="moe", rules="moe", config=BASE, prompts=PROMPTS,
         aot=True),
]


def _jax_module(kind):
    if kind.startswith("moe"):
        return JaxMoETransformer(JaxMoEConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **CONFIGS[kind]))
    return JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **CONFIGS[kind]))


@pytest.fixture(scope="module")
def jax_models():
    return {kind: (_jax_module(kind), seeded_params(_jax_module(kind), seed)) for seed, kind in enumerate(CONFIGS)}


@pytest.fixture(scope="module")
def runs(jax_models, tmp_path_factory):
    """The ranks' results, and JAX's runs (futures) computed here while the
    ranks work: each distinct unsharded run once, each case's sharded run."""
    payload = {
        "cases": CASES,
        "trees": {k: jax.tree_util.tree_map(np.asarray, p) for k, (_, p) in jax_models.items()},
        "configs": CONFIGS,
    }
    tmp = tmp_path_factory.mktemp("generate_tp")
    payload["aot_dir"] = str(tmp / "aot")
    world = World(4, "generate_rank", payload, tmp)
    jobs = {("unsharded", _unsharded_key(c)): functools.partial(_unsharded_run, c, jax_models) for c in CASES}
    jobs.update({("sharded", c["name"]): functools.partial(_sharded, c, jax_models) for c in CASES})
    jax_runs = threaded(jobs)
    return world.results(), jax_runs


def _jax_config(case, mesh=None):
    kw = dict(case["config"])
    if case.get("grammar"):
        texts, pattern, eos = case["grammar"]
        kw["constraints"] = JaxConstraintSet([jax_compile_regex(pattern, texts, eos_id=eos)])
    return JaxGenerationConfig(**kw)


def _jax_run(case, gen):
    if case.get("prefix"):
        return np.asarray(gen(case["prompts"], prefix=gen.cache_prefix(case["prefix"])))
    if case.get("beams"):
        return np.asarray(gen.beam_search(case["prompts"], num_beams=case["beams"]))
    if case.get("constraint"):
        return np.asarray(gen(case["prompts"], constraint=case["constraint"]))
    return np.asarray(gen(case["prompts"]))


def _unsharded_key(case):
    """What JAX's single-device run depends on: cases that make the same call share it."""
    return repr({k: v for k, v in case.items() if k not in ("name", "spec", "rules", "config", "draft", "aot")}) + repr(
        {k: v for k, v in case["config"].items() if k != "sp_prefill"})


def _unsharded_run(case, jax_models):
    """JAX's single-device run."""
    module, params = jax_models[case["model"]]
    cfg = _jax_config(case)
    if case.get("prefix"):  # the plain engine on the whole prompts
        gen = JaxGenerator(module, params, dataclasses.replace(cfg, sp_prefill=None))
        return np.asarray(gen([case["prefix"] + s for s in case["prompts"]]))
    gen = JaxGenerator(module, params, dataclasses.replace(cfg, sp_prefill=None), quantize=case.get("quantize"))
    return _jax_run(case, gen)


def _sharded(case, jax_models):
    module, params = jax_models[case["model"]]
    cfg = _jax_config(case)
    rules = {"llama": jax_llama_rules(), "moe": jax_moe_rules()}.get(case.get("rules"))
    if case.get("draft"):
        d_module, d_params = jax_models["draft"]
        cfg = dataclasses.replace(cfg, draft=JaxDraftSpec(d_module, d_params, gamma=3, partition_rules=rules))
    mesh = JaxMeshSpec(**{"data": 1, **case["spec"]}).build(jax.devices()[:4])
    gen = JaxGenerator(module, params, cfg, mesh=mesh, partition_rules=rules, quantize=case.get("quantize"))
    return _jax_run(case, gen)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_sharded_tokens_equal_jax_unsharded_and_sharded(runs, case):
    world, jax_runs = runs
    name = case["name"]
    if case.get("refused"):
        with pytest.raises(Exception) as refusal:
            jax_runs["sharded", name].result()
        assert type(refusal.value).__name__ == case["refused"], refusal.value
        for rank, res in enumerate(world):
            assert res[name] == res[name + "/stream"] == case["refused"], f"rank {rank}: {res.get(name + '/error', res[name])}"
        return
    unsharded = jax_runs["unsharded", _unsharded_key(case)].result()
    np.testing.assert_array_equal(jax_runs["sharded", name].result(), unsharded)
    for rank, res in enumerate(world):
        np.testing.assert_array_equal(res[name], unsharded, err_msg=f"rank {rank}")
        if name + "/single" in res:  # one prompt: the batch pads up to the data axis
            np.testing.assert_array_equal(res[name + "/single"], unsharded[:1], err_msg=f"rank {rank}")
        if name + "/stream" in res:
            stream = res[name + "/stream"]
            if isinstance(stream, list):  # speculative: ragged per-row chunks
                assert [row.tolist() for row in stream] == unsharded.tolist(), f"rank {rank}"
            else:
                np.testing.assert_array_equal(stream, unsharded, err_msg=f"rank {rank}")


#: the collectives each AOT case's programs must be cut at
AOT_COLLECTIVES = {"tp4-aot": {"all_reduce", "all_gather"}, "ring-aot": {"ring_permute", "all_gather"},
                   "moe-ep2-aot": {"all_reduce", "all_gather"}}


@pytest.mark.parametrize("case", [c for c in CASES if c.get("aot")], ids=lambda c: c["name"])
def test_aot_programs_are_captured_between_their_collectives(runs, case):
    """Each program the store resolved over the mesh is graphs with the
    collectives between them (one more graph than collectives), cut at the
    case's own collectives: the layers' all-reduces and the head's gather
    over ``model``, ring attention's rotations over ``sequence`` (in the
    sequence-parallel prefill), the expert sums over ``expert``; every rank
    compiled its programs, and their tokens are the test above's."""
    world, _ = runs
    name = case["name"]
    for rank, res in enumerate(world):
        programs = res[name + "/aot"]
        assert programs.pop("compiled") > 0, rank
        assert ("_sp_prefill" if case["config"].get("sp_prefill") else "_prefill") in programs, rank
        kinds = set()
        for attr, graphs in programs.items():
            for segments, collectives in graphs:
                assert segments == len(collectives) + 1, (rank, attr)
                kinds.update(collectives)
        assert AOT_COLLECTIVES[name] <= kinds, (rank, kinds)
