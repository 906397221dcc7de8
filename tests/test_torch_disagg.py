"""Disaggregated prefill/decode serving and the elastic fleet of the port
(``serving/replicas.py`` and the engine's handoff pair), held against the
JAX package on the CPU.

``tests/unit/test_disagg.py`` runs here against the port (see
``test_torch_serving_units.py``), every case: role parsing, the scheduler's
role deprioritisation and resize, role-split fleets (dense, paged with the
multi-turn shortcut) token for token equal to solo runs, quiesce, decode-side
radix insertion, ``scale_to`` mid-traffic with no stream lost, the
autoscaler (thread joined by ``close``), ``POST /debug/scale`` and the
``--replica-roles`` delegation. The port's ``ReplicaSet.build`` takes the
model and its config (the port's module holds its weights), so the unit
file's ``build(module, params, cfg, ...)`` calls drop ``params``.

Then converted weights go through the JAX package's meshless ``ReplicaSet``
and the port's, with and without roles, dense, paged, paged over int8 KV
and paged with the radix cache (a second turn takes the shortcut): the
streams (tolerance 0), the routing, handoff and export counters equal; and
one prompt's handoff payload equals JAX's (``first``, ``lengths``, ``echo``
and each page within 1e-5). Last, ``POST /debug/scale`` resizes a real
fleet. Tiny f32 models.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_continuous import _models
from tests.test_torch_serving_units import generator, port_cases, tiny_llama, torch_sklearn_model
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

port_cases(globals(), "test_disagg.py", subs=((r"ReplicaSet\.build\((\s*)module, params, ", r"ReplicaSet.build(\1module, "),))
Generator = generator  # noqa: F811


@pytest.fixture(scope="module")
def tiny():  # noqa: F811
    return tiny_llama(96, seed=1), None


@pytest.fixture
def sklearn_model():
    return torch_sklearn_model()


# ----------------------------------------------------------------- both packages


@pytest.fixture(scope="module")
def pair():
    return _models(dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128), seed=4)


PAIR_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [9, 2, 6, 5, 3, 5, 8, 9, 7, 9], [7, 1], [6, 6, 6, 2, 1, 8]]
#: (engine kwargs, GenerationConfig extras)
MODES = {
    "dense": ({}, {}),
    "paged": (dict(block_size=4), {}),
    "paged-int8-kv": (dict(block_size=4), dict(kv_cache_dtype="int8")),
    "radix": (dict(block_size=4, prefix_cache=True), {}),
}


def _drain_all(fleet, prompts):
    return [[int(t) for c in fleet.submit(p) for t in np.asarray(c).ravel()] for p in prompts]


def _fleet_run(package, pair, mode, roles):
    """A two-replica fleet of ``package`` over the pair's weights: the
    prompts one after another, then (radix) each first prompt's second turn;
    its streams and counters."""
    from unionml_tpu import models as jax_models
    from unionml_tpu.serving.replicas import ReplicaSet as JaxReplicaSet
    from unionml_tpu_torch import models as port_models
    from unionml_tpu_torch.serving.replicas import ReplicaSet

    module, params, flash, _ = pair
    kwargs, extras = MODES[mode]
    kw = dict(replicas=2, slots=2, decode_chunk=3, prefill_threshold=6, autoscale=False, **kwargs)
    if roles:
        kw["roles"] = {"prefill": 1, "decode": 1}
    cfg_kw = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(32,), **extras)
    if package == "jax":
        fleet = JaxReplicaSet.build(module, params, jax_models.GenerationConfig(**cfg_kw), **kw)
    else:
        fleet = ReplicaSet.build(flash, port_models.GenerationConfig(**cfg_kw), **kw)
    try:
        streams = _drain_all(fleet, PAIR_PROMPTS)
        if mode == "radix":
            turns = [p + s + [5, 7] for p, s in zip(PAIR_PROMPTS[:2], streams[:2])]
            streams += _drain_all(fleet, turns)
        stats = fleet.stats()
    finally:
        fleet.close()
    counters = {
        "submitted": stats["scheduler"]["submitted"],
        "handoffs": stats.get("handoffs"),
        "exported": [e.get("handoff", {}).get("exported") for e in stats["per_replica"]],
        "imported": [e.get("handoff", {}).get("imported") for e in stats["per_replica"]],
        "prefix_cache": stats.get("prefix_cache"),
    }
    return streams, counters


@pytest.mark.parametrize("roles", [True, False], ids=["prefill-decode", "mixed"])
@pytest.mark.parametrize("mode", list(MODES))
def test_fleet_equals_jax_fleet(pair, monkeypatch, mode, roles):
    """The JAX package's meshless fleet and the port's, over the same
    weights, knobs and prompts: equal streams, routing, ``handoff_routes``,
    ``handoff_shortcuts``, exports, imports and prefix-cache counters."""
    for name in ("UNIONML_TPU_DP_REPLICAS", "UNIONML_TPU_REPLICA_ROLES", "UNIONML_TPU_PREFILL_THRESHOLD",
                 "UNIONML_TPU_PREFIX_CACHE", "UNIONML_TPU_ADMIT_CHUNK", "UNIONML_TPU_AUTOSCALE_HIGH"):
        monkeypatch.delenv(name, raising=False)
    jax_streams, jax_counters = _fleet_run("jax", pair, mode, roles)
    streams, counters = _fleet_run("port", pair, mode, roles)
    assert streams == jax_streams
    assert counters == jax_counters
    if roles:
        # the two prompts of at least 6 tokens handed off (and, radix, the
        # second turns took the shortcut)
        assert counters["handoffs"]["routed"] == 3
        assert counters["handoffs"]["shortcuts"] == (2 if mode == "radix" else 0)


@pytest.mark.parametrize("mode", ["dense", "paged", "paged-int8-kv"])
def test_handoff_payload_equals_jax(pair, mode):
    """One prompt exported by a prefill-role engine of each package: the
    first token, lengths, echo and produced count equal, and the KV (pages
    in pool layout, or the dense row) leaf for leaf within 1e-5."""
    from unionml_tpu import models as jax_models
    from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
    from unionml_tpu_torch import models as port_models
    from unionml_tpu_torch.serving import ContinuousBatcher

    module, params, flash, _ = pair
    kwargs, extras = MODES[mode]
    cfg_kw = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(32,), **extras)
    prompt = PAIR_PROMPTS[1]
    payloads = []
    for build, gen in (
        (JaxContinuousBatcher._single, jax_models.Generator(module, params, jax_models.GenerationConfig(**cfg_kw))),
        (ContinuousBatcher._single, port_models.Generator(flash, port_models.GenerationConfig(**cfg_kw),
                                                          device="cpu")),
    ):
        engine = build(gen, slots=2, decode_chunk=3, role="prefill", **kwargs)
        try:
            stream = engine.submit(prompt, export_handoff=True)
            first = [int(t) for c in stream for t in np.asarray(c).ravel()]
            payloads.append((first, stream.handoff))
        finally:
            engine.close()
    (jax_first, jax_payload), (first, payload) = payloads
    assert first == jax_first == [payload["first"]]
    for key in ("first", "lengths", "echo", "produced", "max_new", "prompt"):
        assert payload[key] == jax_payload[key], key
    kv = "pages" if "block_size" in kwargs else "row"
    assert (kv in payload) and (kv in jax_payload) and payload.get("block_size") == jax_payload.get("block_size")
    assert len(payload[kv]) == len(jax_payload[kv])
    for layer, jax_layer in zip(payload[kv], jax_payload[kv]):
        assert sorted(layer) == sorted(jax_layer)
        for name in layer:
            got, want = layer[name].numpy(), np.asarray(jax_layer[name])
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=1e-5, rtol=0, err_msg=name)


def test_debug_scale_reaches_a_real_fleet(tiny, sklearn_model):
    """``POST /debug/scale`` on an app whose generation engine is a real
    ``ReplicaSet``: the fleet grows to the asked size (a warmed replica on
    the model's device) and shrinks back, and the answer's health lists
    every replica."""
    import asyncio
    import json

    from unionml_tpu_torch.serving.app import ServingApp
    from unionml_tpu_torch.serving.replicas import ReplicaSet as PortReplicaSet

    sklearn_model.train(hyperparameters={"max_iter": 500})
    app = ServingApp(sklearn_model)
    fleet = PortReplicaSet.build(tiny[0], _cfg(), replicas=1, slots=2, decode_chunk=4, autoscale=False)
    sklearn_model.generation_batcher = fleet

    def dispatch(body):
        async def run():
            app.startup()
            return await app.server.dispatch("POST", "/debug/scale", json.dumps(body).encode())

        return asyncio.run(run())

    try:
        status, payload, _ = dispatch({"replicas": 2})
        assert status == 200 and payload["replicas"] == 2 == fleet.replicas
        assert len(payload["health"]["replicas"]) == 2
        assert _drain(fleet.submit(PROMPTS[0])) == _expected(tiny[0], None, _cfg(), [PROMPTS[0]])[0]
        status, payload, _ = dispatch({"replicas": 1})
        assert status == 200 and fleet.replicas == 1
        assert fleet.stats()["resize"]["scaled_up"] == 1 and fleet.stats()["resize"]["scaled_down"] == 1
    finally:
        del sklearn_model.generation_batcher
        fleet.close()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_import_handoff_under_a_draft_fails_in_jax_and_the_port_refuses(pair, paged):
    """The divergence of ``import_handoff`` under a draft, settled: the JAX
    engine takes the call over a drafted Generator, but its
    ``_import_begin`` prefills no draft row, so its engine thread fails at
    that admission and the stream serves no token (both KV layouts, the
    importer's cache width equal to the exporter's). The port keeps its
    refusal, raised at the call, before any work."""
    from unionml_tpu import models as jax_models
    from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
    from unionml_tpu_torch import models as port_models
    from unionml_tpu_torch.serving import ContinuousBatcher

    module, params, flash, _ = pair
    draft_shape = dict(vocab_size=96, dim=32, n_layers=1, n_heads=2, n_kv_heads=1, hidden_dim=64)
    jax_draft, jax_draft_params, port_draft, _ = _models(draft_shape, seed=5)
    base = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
    # decode_chunk 4 beside gamma 3: both engines' rows hold 16 + 8 + 4 positions
    exporter_kw = dict(slots=2, decode_chunk=4, block_size=4 if paged else None)
    importer_kw = dict(slots=2, decode_chunk=2, block_size=4 if paged else None)

    exporter = JaxContinuousBatcher(jax_models.Generator(module, params, jax_models.GenerationConfig(**base)),
                                    **exporter_kw)
    stream = exporter.submit(PAIR_PROMPTS[0], export_handoff=True)
    assert len(_drain_all_stream(stream)) == 1
    payload = stream.handoff
    exporter.close()
    drafted = jax_models.GenerationConfig(**base, draft=jax_models.DraftSpec(module=jax_draft, params=jax_draft_params,
                                                                            gamma=3))
    importer = JaxContinuousBatcher(jax_models.Generator(module, params, drafted), **importer_kw)
    served = []
    try:
        with pytest.raises(Exception):
            for chunk in importer.import_handoff(payload):
                served += np.asarray(chunk).ravel().tolist()
    finally:
        importer.close()
    assert served == []

    port_exporter = ContinuousBatcher(port_models.Generator(flash, port_models.GenerationConfig(**base), device="cpu"),
                                      **exporter_kw)
    stream = port_exporter.submit(PAIR_PROMPTS[0], export_handoff=True)
    assert len(_drain_all_stream(stream)) == 1
    port_exporter.close()
    port_drafted = port_models.GenerationConfig(**base, draft=port_models.DraftSpec(module=port_draft, gamma=3))
    port_importer = ContinuousBatcher(port_models.Generator(flash, port_drafted, device="cpu"), **importer_kw)
    try:
        with pytest.raises(ValueError, match="import_handoff does not compose with speculative decoding"):
            port_importer.import_handoff(stream.handoff)
    finally:
        port_importer.close()


def _drain_all_stream(stream):
    return [int(t) for c in stream for t in np.asarray(c).ravel()]
