"""The continuous engine over a mesh of gloo ranks, and ``ServingConfig(mesh=)``.

One world of 4 ranks (``tests/torch_mesh_ranks.py``): each case builds the
port's ``Generator`` over a mesh on weights carried from a JAX tree, and a
``ContinuousBatcher`` over it on every rank. Rank 0 submits the prompts from
threads started 30 ms apart, so later prompts arrive while earlier streams
decode: only the step plans rank 0 broadcasts keep the followers in lock
step. Each stream must equal the JAX engine's stream for the same prompt,
knobs and weights (greedy f32):

- ``model=2`` (beside a ``sequence=2`` axis that holds the same rows) and
  ``model=4``; dense slots and the paged pool;
- chunked admission with the radix prefix cache (a second wave hits it);
- an int8 KV pool;
- a pool small enough to preempt residents, which resume token-exactly;
- sp admission: ``sp_prefill="ring"`` over ``sequence=4`` and over
  ``model=2 x sequence=2``;
- per-request grammars over ``model=4``.

Also: ``submit`` on a follower raises; a ``ValueError`` that every rank
meets in an admission's operation fails that stream and the engine serves
on, while one that a follower meets alone ends that follower and surfaces
from its ``close()``; the engine over a ``data=4`` mesh delegates to a
process-aware ``ReplicaSet`` whose streams equal the JAX engine's; and the
JAX unit case
``test_mesh_placement_rounds_buckets_to_data_axis`` runs over ``MeshSpec(
data=4, model=-1)``: buckets round up to the data axis, every rank returns
all the rows, one padded shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parallel import seeded_params
from tests.torch_mesh_ranks import World, threaded
from unionml_tpu.models import ConstraintSet as JaxConstraintSet, compile_regex as jax_compile_regex
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher

torch.set_num_threads(2)

CONFIG = dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3], [9, 2, 6], [7, 1, 8, 2, 8, 1], [4, 6], [5, 5, 5, 1, 2, 7, 7, 1]]
BASE = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
TP2 = dict(model=2, sequence=2)
TEXTS = [""] * 96
for _i in range(26):
    TEXTS[1 + _i] = chr(ord("a") + _i)
GRAMMAR = (TEXTS, r"[a-c]{2,6}", 95)  # a-z over ids 1-26, eos the last id

CASES = [
    dict(name="tp2-dense", spec=TP2, config=BASE, engine=dict(slots=2, decode_chunk=2)),
    dict(name="tp4-paged", spec=dict(model=4), config=BASE, engine=dict(slots=2, decode_chunk=2, block_size=4)),
    dict(name="tp2-chunked-radix", spec=TP2, config=BASE,
         engine=dict(slots=2, decode_chunk=2, block_size=4, admit_chunk=4, prefix_cache=True),
         again=[PROMPTS[0], PROMPTS[4]]),
    dict(name="tp4-int8-pool", spec=dict(model=4), config={**BASE, "kv_cache_dtype": "int8"},
         engine=dict(slots=3, decode_chunk=2, block_size=4)),
    dict(name="tp2-preempt", spec=TP2, config=BASE, engine=dict(slots=3, decode_chunk=2, block_size=2, pool_blocks=14)),
    dict(name="sp4-paged", spec=dict(sequence=4), config={**BASE, "sp_prefill": "ring"},
         engine=dict(slots=2, decode_chunk=2, block_size=4)),
    dict(name="tp2-sp2-dense", spec=TP2, config={**BASE, "sp_prefill": "ring"}, engine=dict(slots=2, decode_chunk=2)),
    dict(name="tp4-constrained", spec=dict(model=4), config={**BASE, "eos_id": 95},
         engine=dict(slots=2, decode_chunk=2, block_size=4), grammar=GRAMMAR, constraint=[1, 0, 1, 0, 1]),
]
for _case in CASES:
    _case["prompts"] = PROMPTS
#: the refusal cases: tp4-paged's knobs, PROMPTS[1]
FAULT = dict(config=BASE, engine=CASES[1]["engine"], prompt=PROMPTS[1])


@pytest.fixture(scope="module")
def jax_model():
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **CONFIG))
    return module, seeded_params(module, 5)


@pytest.fixture(scope="module")
def runs(jax_model, tmp_path_factory):
    """The ranks' results, and the JAX engine's streams (futures) computed
    here while the ranks work."""
    payload = {"cases": CASES, "trees": {"llama": jax.tree_util.tree_map(np.asarray, jax_model[1])},
               "configs": {"llama": CONFIG}, "fault": FAULT}
    world = World(4, "serving_rank", payload, tmp_path_factory.mktemp("serving_mesh"))
    jobs = {(c["name"], "prompts"): functools.partial(_jax_streams, jax_model, c, c["prompts"]) for c in CASES}
    jobs.update({(c["name"], "again"): functools.partial(_jax_streams, jax_model, c, c["again"])
                 for c in CASES if c.get("again")})
    streams = threaded(jobs)
    return world.results(), streams


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


def _jax_streams(jax_model, case, prompts):
    module, params = jax_model
    kw = {k: v for k, v in case["config"].items() if k != "sp_prefill"}
    if case.get("grammar"):
        texts, pattern, eos = case["grammar"]
        kw["constraints"] = JaxConstraintSet([jax_compile_regex(pattern, texts, eos_id=eos)])
    batcher = JaxContinuousBatcher(JaxGenerator(module, params, JaxGenerationConfig(**kw)), **case["engine"])
    grammars = case.get("constraint") or [None] * len(prompts)
    try:
        return [[int(t) for chunk in batcher.submit(p, constraint=g) for t in np.atleast_1d(chunk)]
                for p, g in zip(prompts, grammars)]
    finally:
        batcher.close()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_engine_streams_equal_the_jax_engine(runs, case):
    res, streams = runs[0][0], runs[1]
    name = case["name"]
    assert res[name] == streams[name, "prompts"].result()
    stats = res[name + "/stats"]
    assert stats["decode_dispatches"] > 0 and stats["plans"] > stats["decode_dispatches"]
    if case.get("again"):
        assert res[name + "/again"] == streams[name, "again"].result()
        assert stats["prefix_cache_hits"] >= 1 and stats["prefill_chunks"] > 0
    if name == "tp2-preempt":
        assert stats["preemptions"] > 0  # the pool forced residents out, and they resumed token-exactly


def test_followers_refuse_submit(world):
    for rank, res in enumerate(world[1:], start=1):
        assert res["follower_submit"].startswith("submit to rank 0 of the mesh"), rank


def test_a_refusal_every_rank_meets_keeps_the_ranks_in_step(world):
    """Every rank's first prefill raises ``ValueError``: rank 0 fails that
    stream, the followers drop the admission on rank 0's ``drop_row``, and
    the same prompt then streams as in ``tp4-paged``."""
    assert world[0]["refused_together"] == "_op_prefill_row refused on this rank"
    assert world[0]["after_refusal"] == world[0]["tp4-paged"][1]


def test_a_follower_that_fails_alone_surfaces(world):
    """Rank 1 alone refuses an admission's ``finalize`` while rank 0 serves
    the stream on: rank 1's follower stops and its ``close()`` raises, with
    the refusal as the cause; the other followers end normally."""
    assert world[0]["alone_stream"] == world[0]["tp4-paged"][1][:1]
    message, cause, refusal = world[1]["alone"]
    assert "fell out of step" in message
    assert "rank 1 alone refused an operation of admission" in cause and "rank 0 went on" in cause
    assert "_op_finalize refused on this rank" in refusal
    assert "alone" not in world[2] and "alone" not in world[3]


def test_engine_over_a_data_axis_is_refused(runs):
    """The engine over a ``data=4`` mesh is no longer refused: as in the JAX
    package it returns a ``ReplicaSet``, process-aware here (each rank
    builds the one replica of its batch slice, a submesh of one rank), and
    each rank's stream equals the JAX engine's for that prompt."""
    world, streams = runs
    expected = streams["tp4-paged", "prompts"].result()
    for rank, res in enumerate(world):
        assert res["data_fleet"] == ("ReplicaSet", 1, rank, 1)
        assert res["data_stream"] == expected[rank]


def test_mesh_placement_rounds_buckets_to_data_axis(world):
    """``tests/unit/test_compiled_predictor.py``'s mesh case on four ranks."""
    for res in world:
        buckets, out, traces = res["compiled"]
        assert buckets == (4, 8)  # rounded up to multiples of the data axis
        np.testing.assert_allclose(out, np.arange(9, dtype=np.float32).reshape(3, 3) @ np.arange(3.0), rtol=1e-6)
        assert out.shape == (3,) and traces == 1

