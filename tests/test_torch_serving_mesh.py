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
- per-request grammars over ``model=4``;
- ``aot=``: ring admission over ``model=2 x sequence=2`` and the paged pool,
  and a drafted engine over ``model=2``, with every program (the draft's
  too) captured in segments between its collectives (tapes of aten ops
  standing in for CUDA graphs);
- speculative decoding with a tiny draft (its own weights, seed 5): dense
  over ``model=2``, paged over ``model=4``, under ring admission over
  ``model=2 x sequence=2``, composed with int8 weights, an int8 KV pool, a
  static prefix and grammars (``test_everything_composes_over_tp_mesh``'s
  knobs), under preemption, and one stream at a time, where the leader's
  rounds, accepted and proposed counts and ``acceptance_rate`` must equal
  the port's unsharded engine's on the same streams; and the target as its
  own draft, cut under ``llama_partition_rules()`` over ``model=2`` and,
  under ring admission, over ``model=2 x sequence=2``. Each draft case runs
  its prompts again one at a time on a fresh engine, where the leader's
  rounds, accepted count, ``acceptance_rate`` and dispatches must equal the
  JAX engine's on the same streams, and the self cases must accept nearly
  every proposal: a greedy stream is the target's whatever the draft
  proposes, the counters are not.

A sampled speculative case (``temperature=0.8``) holds every follower's
carried ``out_buf`` and ``produced`` equal to the leader's after each
dispatch, array for array: the draws are the leader's, broadcast.

Also: ``submit`` on a follower raises; a ``ValueError`` that every rank
meets in an admission's operation fails that stream and the engine serves
on, while one that a follower meets alone ends that follower and surfaces
from its ``close()``; the engine over a ``data=4`` mesh delegates to a
process-aware ``ReplicaSet`` whose streams equal the JAX engine's, and so
does one over ``data=2 x model=2`` with a draft (two replicas of two ranks,
each draft cut to its replica's submesh); the refusals a draft keeps over a
mesh raise with the JAX engine's words; and the JAX unit case
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
from unionml_tpu.models import ConstraintSet as JaxConstraintSet, DraftSpec as JaxDraftSpec
from unionml_tpu.models import compile_regex as jax_compile_regex
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

CONFIG = dict(vocab_size=96, dim=64, n_layers=2, n_heads=8, n_kv_heads=4, hidden_dim=128)
#: the JAX package's tiny draft of ``test_everything_composes_over_tp_mesh``:
#: one KV head, so its inferred layout leaves it whole on every rank
DRAFT = dict(vocab_size=96, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64)
#: a target that drafts for itself accepts almost every proposal: in the
#: self cases the share of proposals that had budget room and were accepted
#: must reach this (the JAX engine's ``acceptance_rate`` is 1.0 on them)
SELF_ACCEPTANCE = 0.9
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
    # ``draft`` is the draft's gamma
    dict(name="tp2-draft-dense", spec=TP2, config=BASE, draft=3, engine=dict(slots=2, decode_chunk=2)),
    dict(name="tp4-draft-paged", spec=dict(model=4), config=BASE, draft=3,
         engine=dict(slots=2, decode_chunk=2, block_size=4)),
    dict(name="tp2-sp2-draft", spec=TP2, config={**BASE, "sp_prefill": "ring"}, draft=3,
         engine=dict(slots=2, decode_chunk=2)),
    dict(name="tp2-draft-composed", spec=TP2, config={**BASE, "eos_id": 95, "kv_cache_dtype": "int8"}, draft=2,
         quantize="int8", prefix=[11, 12, 13, 14], engine=dict(slots=2, decode_chunk=2, block_size=4),
         grammar=GRAMMAR, constraint=[1, 0, 1, 0, 1]),
    # cache_len 16 + 8 + gamma + 1 = 28: the pool holds one worst-case request
    dict(name="tp2-draft-preempt", spec=TP2, config=BASE, draft=3,
         engine=dict(slots=3, decode_chunk=2, block_size=2, pool_blocks=14)),
    dict(name="tp2-draft-telemetry", spec=TP2, config=BASE, draft=3, engine=dict(slots=2, decode_chunk=2),
         sequential=True),
    # the target as its own draft (other module objects, the same weights), cut
    # under llama_partition_rules(): two KV heads a model rank, its rows
    # prefilled sequence-parallel under ring admission
    dict(name="tp2-draft-self", spec=TP2, config=BASE, draft=3, draft_tree="llama", draft_rules=True,
         engine=dict(slots=2, decode_chunk=2, block_size=4)),
    dict(name="tp2-sp2-draft-self", spec=TP2, config={**BASE, "sp_prefill": "ring"}, draft=3, draft_tree="llama",
         draft_rules=True, engine=dict(slots=2, decode_chunk=2)),
    # aot=: every program through the AOT store, captured in segments between its collectives (tapes of aten ops
    # on the CPU): ring admission over model=2 x sequence=2 and the paged pool
    dict(name="tp2-sp2-aot", spec=TP2, config={**BASE, "sp_prefill": "ring"}, aot=True,
         engine=dict(slots=2, decode_chunk=2, block_size=4)),
    # ... and under a draft: the draft's programs through the store too, the rounds eager between them
    dict(name="tp2-draft-aot", spec=TP2, config=BASE, draft=3, aot=True, engine=dict(slots=2, decode_chunk=2)),
]
#: the cases with a greedy draft: the leader's counters over a pass of one stream at a time
DRAFT_CASES = [c for c in CASES if c.get("draft")]
#: no JAX stream to equal: the ranks must stay in lock step
SAMPLED = dict(name="tp2-draft-sampled", spec=TP2, config={**BASE, "temperature": 0.8}, draft=3,
               engine=dict(slots=2, decode_chunk=2, block_size=4), lockstep=True)
#: the draft over a data axis (a replica of two ranks a slice), and the refusals it keeps over a mesh
DP_DRAFT = dict(name="dp2-tp2-draft", spec=dict(data=2, model=2), config=BASE, draft=3, draft_tree="llama",
                draft_rules=True, engine=dict(slots=2, decode_chunk=2))
REFUSALS = dict(spec=TP2, config=BASE, draft=3, engine=dict(slots=2, decode_chunk=2))
for _case in CASES + [SAMPLED, DP_DRAFT, REFUSALS]:
    _case["prompts"] = PROMPTS
#: the refusal cases: tp4-paged's knobs, PROMPTS[1]
FAULT = dict(config=BASE, engine=CASES[1]["engine"], prompt=PROMPTS[1])


@pytest.fixture(scope="module")
def jax_model():
    models = {}
    for kind, config in {"llama": CONFIG, "draft": DRAFT}.items():
        module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **config))
        models[kind] = (module, seeded_params(module, 5))
    return models


@pytest.fixture(scope="module")
def runs(jax_model, tmp_path_factory):
    """The ranks' results, and the JAX engine's streams (futures) computed
    here while the ranks work."""
    trees = {kind: params for kind, (_, params) in jax_model.items()}
    payload = {"cases": CASES + [SAMPLED], "trees": jax.tree_util.tree_map(np.asarray, trees),
               "configs": {"llama": CONFIG, "draft": DRAFT}, "fault": FAULT, "dp_draft": DP_DRAFT,
               "refusals": REFUSALS}
    tmp = tmp_path_factory.mktemp("serving_mesh")
    payload["aot_dir"] = str(tmp / "aot")
    world = World(4, "serving_rank", payload, tmp)
    jobs = {(c["name"], "prompts"): functools.partial(_jax_streams, jax_model, c, c["prompts"]) for c in CASES}
    jobs.update({(c["name"], "again"): functools.partial(_jax_streams, jax_model, c, c["again"])
                 for c in CASES if c.get("again")})
    jobs[DP_DRAFT["name"], "prompts"] = functools.partial(_jax_streams, jax_model, DP_DRAFT, DP_DRAFT["prompts"])
    jobs["refusals"] = functools.partial(_jax_refusals, jax_model)
    streams = threaded(jobs)
    return world.results(), streams


@pytest.fixture(scope="module")
def world(runs):
    return runs[0]


def _jax_generator(jax_model, case):
    """The JAX package's unsharded ``Generator`` for a case (its draft too)."""
    module, params = jax_model["llama"]
    kw = {k: v for k, v in case["config"].items() if k != "sp_prefill"}
    if case.get("grammar"):
        texts, pattern, eos = case["grammar"]
        kw["constraints"] = JaxConstraintSet([jax_compile_regex(pattern, texts, eos_id=eos)])
    if case.get("draft"):
        draft, draft_params = jax_model[case.get("draft_tree", "draft")]
        kw["draft"] = JaxDraftSpec(module=draft, params=draft_params, gamma=case["draft"])
    return JaxGenerator(module, params, JaxGenerationConfig(**kw), quantize=case.get("quantize"))


def _jax_streams(jax_model, case, prompts):
    """The JAX engine's streams, one at a time; under a draft also its
    counters over them (``spec``: rounds, accepted, ``acceptance_rate``,
    dispatches)."""
    gen = _jax_generator(jax_model, case)
    knobs = dict(case["engine"])
    if case.get("prefix"):
        knobs["prefix"] = gen.cache_prefix(case["prefix"])
    batcher = JaxContinuousBatcher(gen, **knobs)
    grammars = case.get("constraint") or [None] * len(prompts)
    try:
        streams = [[int(t) for chunk in batcher.submit(p, constraint=g) for t in np.atleast_1d(chunk)]
                   for p, g in zip(prompts, grammars)]
        stats = batcher.stats()
        spec = batcher._spec and {"rounds": batcher._spec.rounds, "accepted": batcher._spec.accepted_tokens,
                                  "acceptance_rate": stats.get("acceptance_rate"),
                                  "decode_dispatches": stats["decode_dispatches"]}
        return {"streams": streams, "spec": spec}
    finally:
        batcher.close()


def _jax(streams, *key):
    """The JAX engine's streams for ``key``."""
    return streams[key].result()["streams"]


def _jax_refusals(jax_model):
    """The JAX engine's words for each refusal a draft keeps (its engine
    takes a draft's import; the port refuses it, as its export)."""
    gen = _jax_generator(jax_model, REFUSALS)
    said = {}
    for label, knobs in (("prefix_cache", dict(block_size=4, prefix_cache=True)), ("role", dict(role="prefill"))):
        with pytest.raises(ValueError) as exc:
            JaxContinuousBatcher(gen, **REFUSALS["engine"], **knobs)
        said[label] = str(exc.value)
    batcher = JaxContinuousBatcher(gen, **REFUSALS["engine"])
    try:
        for label, kw in (("logprobs", dict(logprobs=True)), ("export_handoff", dict(export_handoff=True))):
            with pytest.raises(ValueError) as exc:
                batcher.submit(PROMPTS[0], **kw)
            said[label] = str(exc.value)
    finally:
        batcher.close()
    return said


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_engine_streams_equal_the_jax_engine(runs, case):
    res, streams = runs[0][0], runs[1]
    name = case["name"]
    assert res[name] == _jax(streams, name, "prompts")
    stats = res[name + "/stats"]
    assert stats["decode_dispatches"] > 0 and stats["plans"] > stats["decode_dispatches"]
    if case.get("again"):
        assert res[name + "/again"] == _jax(streams, name, "again")
        assert stats["prefix_cache_hits"] >= 1 and stats["prefill_chunks"] > 0
    if name in ("tp2-preempt", "tp2-draft-preempt"):
        assert stats["preemptions"] > 0  # the pool forced residents out, and they resumed token-exactly


def test_aot_engine_captures_ring_admission_between_its_collectives(world):
    """``tp2-sp2-aot`` (its streams are held to the JAX engine's above):
    every rank compiled its programs into the store, each program is one
    graph more than the collectives between them, and the
    sequence-parallel prefill is cut at ring attention's rotations over
    ``sequence`` and the layers' all-reduces over ``model``. Under
    ``tp2-draft-aot`` the target's and the draft's prefills went through
    the store too (its streams and counters are held to JAX's above)."""
    for rank, res in enumerate(world):
        programs = dict(res["tp2-sp2-aot/aot"])
        assert programs.pop("compiled") > 0, rank
        for attr, graphs in programs.items():
            for segments, collectives in graphs:
                assert segments == len(collectives) + 1, (rank, attr)
        ring = {kind for _, collectives in programs["_sp_prefill"] for kind in collectives}
        assert {"ring_permute", "all_reduce", "all_gather"} <= ring, (rank, ring)
        assert programs["_decode"], rank
        drafted = world[rank]["tp2-draft-aot/aot"]
        assert drafted["compiled"] > 0 and drafted["_prefill"] and drafted["draft_prefill"], rank
        for segments, collectives in drafted["draft_prefill"]:
            assert segments == len(collectives) + 1, rank


def _spec_equals_jax(spec, jax_spec):
    """The leader's counters against the JAX engine's on the same streams:
    exact (greedy f32 acceptance compares token ids)."""
    assert {k: spec[k] for k in jax_spec} == jax_spec
    assert spec["rounds"] > 0 and spec["proposed"] >= spec["accepted"]


@pytest.mark.parametrize("case", DRAFT_CASES, ids=lambda c: c["name"])
def test_draft_counters_equal_the_jax_engine(runs, case):
    """The prompts one at a time on a fresh engine over the case's mesh:
    the streams equal the JAX engine's, and so do the leader's rounds,
    accepted count, ``acceptance_rate`` and dispatches, which depend on
    what the draft proposes: a draft row cut or prefilled wrongly on any
    rank is accepted less. The target as its own draft accepts at least
    ``SELF_ACCEPTANCE`` of its proposals."""
    res, streams = runs[0][0], runs[1]
    name = case["name"]
    jax_run = streams[name, "prompts"].result()
    if not case.get("sequential"):
        assert res[name + "/one_by_one"] == jax_run["streams"]
    _spec_equals_jax(res[name + "/spec"], jax_run["spec"])
    if case.get("draft_tree") == "llama":
        spec = res[name + "/spec"]
        assert spec["accepted"] / spec["proposed"] >= SELF_ACCEPTANCE


def test_draft_telemetry_equals_the_unsharded_engine(runs):
    """One stream at a time over ``model=2``: the leader's rounds, accepted
    and proposed counts and ``acceptance_rate`` equal the port's unsharded
    engine's on the same weights and prompts and the JAX engine's, and both
    engines' streams equal the JAX engine's."""
    res, streams = runs[0][0], runs[1]
    name = "tp2-draft-telemetry"
    spec, solo = res[name + "/spec"], res[name + "/solo_spec"]
    assert spec == solo
    _spec_equals_jax(spec, streams[name, "prompts"].result()["spec"])
    assert res[name + "/solo"] == res[name] == _jax(streams, name, "prompts")


def test_sampled_draft_ranks_stay_in_lock_step(world):
    """``temperature=0.8``: after each speculative dispatch every follower
    carries the leader's ``out_buf`` and ``produced``, array for array, and
    each stream has its budget of in-vocabulary tokens."""
    name = SAMPLED["name"]
    leader = world[0][name + "/lockstep"]
    assert len(leader) > 0
    for rank, res in enumerate(world[1:], start=1):
        mine = res[name + "/lockstep"]
        assert len(mine) == len(leader), rank
        for (out_buf, produced), (lead_buf, lead_produced) in zip(mine, leader):
            np.testing.assert_array_equal(out_buf, lead_buf)
            np.testing.assert_array_equal(produced, lead_produced)
    for stream in world[0][name]:
        assert len(stream) == BASE["max_new_tokens"] and all(0 <= t < CONFIG["vocab_size"] for t in stream)


def test_draft_over_a_data_axis_serves_through_replicas(runs):
    """``data=2 x model=2`` with the target as its own draft: the
    Generator's call over the whole mesh, then the engine: each rank builds
    its slice's replica (two ranks, its draft gathered back and cut over
    that submesh's model axis), each leader serves half the prompts one at
    a time, and every stream equals the JAX engine's. The two leaders'
    rounds and accepted counts sum to the JAX engine's over all the
    prompts, with ``SELF_ACCEPTANCE`` or more of the proposals accepted."""
    world, streams = runs
    jax_run = streams[DP_DRAFT["name"], "prompts"].result()
    expected = jax_run["streams"]
    served, counters = {}, []
    for rank, res in enumerate(world):
        assert res["dp_draft_call"] == expected[:2]  # the Generator's own call over the whole mesh, draft and all
        assert res["dp_draft_fleet"] == ("ReplicaSet", rank // 2, 2, True, 2)  # the draft's two KV heads a rank
        served.update(res.get("dp_draft", {}))
        counters += [res["dp_draft_spec"]] if "dp_draft_spec" in res else []
    assert sorted(served) == list(range(len(PROMPTS)))
    assert [served[i] for i in range(len(PROMPTS))] == expected
    assert len(counters) == 2
    rounds, accepted, proposed = (sum(c[k] for c in counters) for k in ("rounds", "accepted", "proposed"))
    assert (rounds, accepted) == (jax_run["spec"]["rounds"], jax_run["spec"]["accepted"])
    assert accepted / proposed >= SELF_ACCEPTANCE


def test_refusals_a_draft_keeps_over_a_mesh(runs):
    """prefix_cache, the prefill role, logprobs and export_handoff raise
    over ``model=2`` with the JAX engine's words; import_handoff raises as
    the port's unsharded engine does; the engine then serves."""
    world, streams = runs
    said, jax_said = world[0]["draft_refusals"], streams["refusals"].result()
    for label in ("prefix_cache", "role", "logprobs", "export_handoff"):
        assert said[label] == jax_said[label], label
    assert said["import_handoff"] == "import_handoff does not compose with speculative decoding (config.draft)"
    assert said["served"] == _jax(streams, "tp2-draft-dense", "prompts")[0]
    for res in world[1:]:
        assert res["draft_refusals"] == {k: said[k] for k in ("prefix_cache", "role")}


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
    expected = _jax(streams, "tp4-paged", "prompts")
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

