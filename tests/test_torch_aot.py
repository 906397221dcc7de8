"""The AOT program store (``unionml_tpu_torch/serving/aot.py``) on the CPU:
the cases of ``tests/unit/test_aot.py`` by name, against the port.

On CPU tensors there is no graph: the store keys, counts and writes every
entry as on the card and the programs run eagerly. So a process whose store
holds this configuration's programs resolves every one from it (zero fresh
captures: ``prefill_traces``/``decode_traces`` read ``(0, 0)``), stale and
corrupt entries are skipped, deleted and rewritten, and every stream equals
the JAX package's plain ``Generator`` on the same converted weights (JAX's
own AOT path fails under its installed version, so it is no oracle). JAX's
mesh-mismatch case becomes the refusal of ``aot=`` over a mesh.

The graph route's buffer handling (static copies, a written-in-place input
bound by identity and another caller's swapped in and back out, cloned
outputs, the generator's state carried across a
replay, launches per replay) is held on the CPU through the module's capture
seams: ``_capturable`` admits CPU tensors and ``_begin_graph``/``_end_graph``
record each graph as a tape of aten ops, which a replay runs again on the
captured tensors (``tests/torch_graph_tape.py``).
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unionml_tpu.models import GenerationConfig as JaxGenerationConfig, Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving.aot import ProgramStore as JaxProgramStore
from unionml_tpu_torch import _build
from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig, llama_params_from_jax
from unionml_tpu_torch.serving import ContinuousBatcher
from unionml_tpu_torch.serving import aot
from unionml_tpu_torch.serving.aot import AOTFunction, ProgramStore, resolve_store
from tests import torch_graph_tape
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

SHAPE = dict(vocab_size=89, dim=32, n_layers=2, n_heads=2, n_kv_heads=2, hidden_dim=64)
PROMPT = [3, 14, 15, 9, 2]
PROMPTS = [PROMPT, [7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5], [44]]


@pytest.fixture(scope="module")
def tiny():
    """The JAX test's model (``LlamaConfig.tiny``, 2 layers, dim 32, f32,
    PRNGKey(0)) and the port's config and converted weights."""
    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE))
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **SHAPE)
    return module, params, cfg, llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)


@pytest.fixture(scope="module")
def model(tiny):
    _, _, cfg, state = tiny
    llama = Llama(cfg, device="cpu")
    llama.load_state_dict(state)
    return llama


@pytest.fixture(scope="module")
def ref(tiny):
    """JAX's plain ``Generator`` on each prompt alone: what every stream must be."""
    module, params, _, _ = tiny
    gen = JaxGenerator(module, params, JaxGenerationConfig(**_kw()))
    return [np.asarray(gen([p]))[0].tolist() for p in PROMPTS]


@pytest.fixture(autouse=True)
def no_preload_export(monkeypatch):
    monkeypatch.delenv("UNIONML_TPU_AOT_PRELOAD", raising=False)


def _kw(**overrides):
    return dict(dict(max_new_tokens=6, temperature=0.0, prompt_buckets=(8, 16)), **overrides)


def _cfg(**overrides):
    return GenerationConfig(**_kw(**overrides))


def _drain(stream):
    return [int(t) for chunk in stream for t in np.asarray(chunk).ravel()]


def _streams(batcher, prompts, concurrent):
    """Each prompt's stream: submitted one after another (each request's
    sampling seed then follows the same order on every engine), or all at
    once from threads (their rows share decode dispatches)."""
    if not concurrent:
        return [_drain(batcher.submit(p)) for p in prompts]
    out = [None] * len(prompts)

    def run(i):
        out[i] = _drain(batcher.submit(prompts[i]))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    return out


def _serve_one(model, tmp, prompts=(PROMPT,), cfg=None, concurrent=False, **engine_kwargs):
    gen = Generator(model, cfg or _cfg(), device="cpu")
    batcher = ContinuousBatcher(gen, slots=2, decode_chunk=4, aot=tmp, **engine_kwargs)
    try:
        batcher.warmup()
        tokens = _streams(batcher, prompts, concurrent)
        return gen, tokens if len(prompts) > 1 else tokens[0], batcher.stats()
    finally:
        batcher.close()


# ------------------------------------------------------------------ key derivation


def test_entry_key_stable_and_sensitive(tmp_path):
    store = ProgramStore(str(tmp_path))
    key = store.entry_key("prefill", {"mesh": None}, ("sig",))
    assert key == store.entry_key("prefill", {"mesh": None}, ("sig",))  # deterministic
    assert key != store.entry_key("decode", {"mesh": None}, ("sig",))  # program name
    assert key != store.entry_key("prefill", {"mesh": [0, 1]}, ("sig",))  # context
    assert key != store.entry_key("prefill", {"mesh": None}, ("other",))  # signature
    # the store-level context (torch version, kernel digests) keys too
    other = ProgramStore(str(tmp_path))
    other._context = dict(other._context, torch="0.0.0-stale")
    assert key != other.entry_key("prefill", {"mesh": None}, ("sig",))
    edited = ProgramStore(str(tmp_path))
    edited._context = dict(edited._context, kernels={**edited._context["kernels"], "int8_matmul": "0" * 16})
    assert key != edited.entry_key("prefill", {"mesh": None}, ("sig",))  # an edited kernel misses
    # the stats() key set is the JAX store's (/metrics and the fleet sum read it)
    assert store.stats().keys() == JaxProgramStore(str(tmp_path / "jax")).stats().keys()


def test_store_meta_sidecars_record_programs(tmp_path, model):
    _serve_one(model, str(tmp_path))
    entries = ProgramStore(str(tmp_path)).entries()
    assert entries, "warmup should have persisted entries"
    programs = {entry["program"] for entry in entries}
    assert {"prefill", "decode"} <= programs  # the admission scatters launch no kernel: plain calls
    for entry in entries:
        assert entry["store"]["torch"] == torch.__version__
        assert entry["store"]["kernels"] == _build.library_digests()
        assert entry["context"]["device"] == {"type": "cpu"}
        assert "signature" in entry and entry["graph"] is False  # no graph on CPU tensors
        assert entry["launches"] == {}  # the kernels' plain twins launch nothing


# ------------------------------------------------------------------ exactness


def test_populated_store_serves_with_zero_traces_and_identical_tokens(tmp_path, model, ref):
    plain = Generator(model, _cfg(), device="cpu")
    plain_b = ContinuousBatcher(plain, slots=2, decode_chunk=4)
    try:
        plain_b.warmup()
        assert _drain(plain_b.submit(PROMPT)) == ref[0]
    finally:
        plain_b.close()

    gen1, out1, stats1 = _serve_one(model, str(tmp_path))
    assert out1 == ref[0]
    assert stats1["aot"]["programs_compiled"] > 0
    assert stats1["aot"]["programs_serialized"] == stats1["aot"]["programs_compiled"]
    assert stats1["aot"]["programs_loaded"] == 0
    assert gen1.prefill_traces > 0 and gen1.decode_traces > 0

    gen2, out2, stats2 = _serve_one(model, str(tmp_path))
    assert out2 == ref[0]
    assert (gen2.prefill_traces, gen2.decode_traces) == (0, 0)  # every program from the store
    assert stats2["aot"]["programs_compiled"] == 0
    assert stats2["aot"]["programs_loaded"] > 0
    assert stats2["aot"]["load_ms"]["window"] == stats2["aot"]["programs_loaded"]
    assert stats2["aot"]["compile_ms"] == {"window": 0}  # never a None gauge


def test_generator_warmup_preloads(tmp_path, model, tiny):
    module, params, _, _ = tiny
    want = np.asarray(JaxGenerator(module, params, JaxGenerationConfig(**_kw()))([PROMPT]))
    store = ProgramStore(str(tmp_path))
    Generator(model, _cfg(), device="cpu").enable_aot(store).warmup()
    assert store.programs_compiled > 0

    store2 = ProgramStore(str(tmp_path))
    gen2 = Generator(model, _cfg(), device="cpu").enable_aot(store2).warmup()
    assert store2.programs_compiled == 0 and store2.programs_loaded > 0
    assert (gen2.prefill_traces, gen2.decode_traces) == (0, 0)
    np.testing.assert_array_equal(gen2([PROMPT]), want)
    assert (gen2.prefill_traces, gen2.decode_traces) == (0, 0)  # the call itself hit too


# ------------------------------------------------------------------ staleness / corruption


def test_stale_torch_version_entries_are_skipped(tmp_path, model):
    """JAX's ``test_stale_jax_version_entries_are_skipped``: entries written
    under another framework version never load."""
    stale = ProgramStore(str(tmp_path))
    stale._context = dict(stale._context, torch="0.0.0-stale")
    Generator(model, _cfg(), device="cpu").enable_aot(stale).warmup()
    n_entries = stale.entry_count()
    assert n_entries > 0

    fresh = ProgramStore(str(tmp_path))
    gen = Generator(model, _cfg(), device="cpu").enable_aot(fresh).warmup()
    assert fresh.programs_loaded == 0  # stale keys never resolve
    assert fresh.programs_compiled > 0  # ...so it compiled, without crashing
    assert gen.prefill_traces > 0
    assert fresh.entry_count() == n_entries * 2  # old entries orphaned, not clobbered


#: the JAX mesh oracle's model (``tests/emulated/test_aot_tp.py``: PRNGKey(1))
MESH_SHAPE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
MESH_GEN = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
MESH_PROMPTS = [[3, 1, 4, 1, 5, 9, 2], [9, 2, 6], [7, 1, 8, 2, 8, 1, 8, 2, 8, 4]]
#: (a)'s engines: the paged pool; (b)'s fleet: the JAX oracle's dense knobs
MESH_ENGINE = dict(slots=2, decode_chunk=4, block_size=4)
FLEET_ENGINE = dict(slots=2, decode_chunk=4)


def _jax_mesh_streams(module, params, mesh_devices, knobs):
    """The JAX engine's streams, one prompt at a time: over ``model=2`` on
    two emulated devices (``mesh_devices``), or unsharded."""
    from unionml_tpu.models import llama_partition_rules as jax_rules
    from unionml_tpu.parallel import MeshSpec as JaxMeshSpec
    from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher

    mesh = JaxMeshSpec(model=2).build(devices=mesh_devices) if mesh_devices else None
    gen = JaxGenerator(module, params, JaxGenerationConfig(**MESH_GEN), mesh=mesh,
                       partition_rules=jax_rules() if mesh is not None else None)
    batcher = JaxContinuousBatcher(gen, **knobs)
    try:
        return [_drain(batcher.submit(p)) for p in MESH_PROMPTS]
    finally:
        batcher.close()


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """One world of 4 gloo ranks (``aot_rank`` in ``tests/torch_mesh_ranks.py``,
    every capture a tape), and JAX's eager engines over ``model=2`` and
    unsharded, computed here while the ranks run."""
    from tests.torch_mesh_ranks import World, threaded

    module = JaxLlama(JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **MESH_SHAPE))
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    tmp = tmp_path_factory.mktemp("aot_mesh")
    payload = {"tree": jax.tree_util.tree_map(np.asarray, params), "config": MESH_SHAPE, "gen": MESH_GEN,
               "prompts": MESH_PROMPTS, "engine": MESH_ENGINE, "fleet_engine": FLEET_ENGINE,
               "dir": str(tmp / "stores")}
    world = World(4, "aot_rank", payload, tmp, timeout=400)
    jax_runs = threaded({
        "tp2": lambda: _jax_mesh_streams(module, params, jax.devices()[:2], MESH_ENGINE),
        "tp2_fleet": lambda: _jax_mesh_streams(module, params, jax.devices()[2:4], FLEET_ENGINE),
        "single": lambda: _jax_mesh_streams(module, params, None, FLEET_ENGINE),
    })
    return world.results(), {key: future.result() for key, future in jax_runs.items()}


def test_mesh_miss_then_hit_serves_the_jax_mesh_engines_tokens(mesh_world):
    """JAX's ``test_tp2_preload_then_serve_token_identical`` over the port's
    ranks: each pair of ranks serves a model=2 submesh eagerly, then on an
    empty store (every program captured in segments and written), then a
    fresh Generator and engine on the populated store: zero captures, every
    program loaded, and every stream equal to JAX's eager model=2 engine, to
    JAX's unsharded one and to the port's eager mesh engine. Each graph of a
    program ends at a collective, which a replay runs between two graphs."""
    ranks, jax_runs = mesh_world
    assert jax_runs["tp2"] == jax_runs["single"]
    for rank, res in enumerate(ranks):
        if rank % 2 == 0:
            assert res["eager"] == res["miss"] == res["hit"] == jax_runs["tp2"], rank
        miss, hit = res["miss/aot"], res["hit/aot"]
        assert miss["programs_compiled"] > 0 and miss["programs_loaded"] == 0, rank
        assert hit["programs_compiled"] == 0 and hit["programs_loaded"] == miss["programs_compiled"], rank
        assert res["miss/traces"][0] > 0 and res["miss/traces"][1] > 0
        assert res["hit/traces"] == (0, 0), rank
        for label in ("miss", "hit"):
            programs = res[label + "/programs"]
            assert {"_prefill", "_decode"} <= {name for name, graphs in programs.items() if graphs}
            for name, graphs in programs.items():
                for segments, collectives in graphs:
                    assert collectives and segments == len(collectives) + 1, (rank, name)
                    assert set(collectives) <= {"all_reduce", "all_gather"}, (rank, name)
        assert res["hit/programs"] == res["miss/programs"], rank


def test_mesh_scale_up_preloads_on_the_revisited_submesh(mesh_world):
    """JAX's ``test_scale_up_preloads_on_reused_submesh``: the process-aware
    ``ReplicaSet`` over ``data=2 x model=2`` warms both replicas (each
    compiles and writes its submesh's programs); ``scale_to(1)`` parks
    replica 1 (ranks 2-3 drain and close it) and ``scale_to(2)`` builds it
    again there: its new Generator loads every program with zero captures,
    and both leaders' streams equal JAX's eager model=2 engine's."""
    ranks, jax_runs = mesh_world
    for rank, res in enumerate(ranks):
        assert res["fleet/first"]["programs_compiled"] > 0, rank
        parked = rank >= 2
        assert res["fleet/scaled_down"] == (1, 0 if parked else 1), rank
        assert res["fleet/scaled_up"] == (2, 1), rank
        assert res["fleet/rebuilt"] is parked and res["fleet/slice"] == rank // 2, rank
        if parked:
            assert res["fleet/traces"] == (0, 0), rank
            assert res["fleet/aot"]["programs_compiled"] == 0 and res["fleet/aot"]["programs_loaded"] > 0, rank
        if rank % 2 == 0:
            assert res["fleet/streams"] == jax_runs["tp2_fleet"], rank


def test_mesh_ranks_share_one_entry_per_program_and_the_export_arms_the_store(mesh_world):
    """Two ranks of one device context write each program's entry under one
    key, each atomically: a pair's store holds exactly one readable entry
    (payload and sidecar, no temporary file) per program either rank
    resolved, its sidecar recording the segments and the collectives
    between them. ``UNIONML_TPU_AOT_PRELOAD`` arms the store over a mesh as
    on one device: that engine loads every program and serves JAX's
    tokens."""
    ranks, jax_runs = mesh_world
    for pair in (0, 1):
        leader, follower = ranks[2 * pair], ranks[2 * pair + 1]
        assert leader["miss/keys"] == follower["miss/keys"]
        files = leader["files"]
        assert not [name for name in files if ".tmp" in name]
        assert sorted(name for name in files if name.endswith(".aotx")) == [k + ".aotx" for k in leader["miss/keys"]]
        assert sorted(name for name in files if name.endswith(".json")) == [k + ".json" for k in leader["miss/keys"]]
        assert leader["readable"]
        for entry in leader["entries"]:
            assert entry["graph"] is True and entry["segments"] == len(entry["collectives"]) + 1
            assert entry["context"]["mesh"]["ranks"] == [2 * pair, 2 * pair + 1]
        for res in (leader, follower):
            assert res["export/aot"]["programs_compiled"] == 0 and res["export/aot"]["programs_loaded"] > 0
            assert res["export/traces"] == (0, 0)
        assert leader["export"] == jax_runs["tp2"]


def test_corrupted_entries_fall_back_to_compile(tmp_path, model, ref):
    _, out0, _ = _serve_one(model, str(tmp_path))
    assert out0 == ref[0]
    for name in os.listdir(tmp_path):
        if name.endswith(".aotx"):
            (tmp_path / name).write_bytes(b"not an AOT entry")

    gen, out, stats = _serve_one(model, str(tmp_path))
    assert out == ref[0]  # corruption degrades to compile, identically
    assert stats["aot"]["load_failures"] > 0
    assert stats["aot"]["programs_compiled"] > 0
    assert gen.prefill_traces > 0

    # the recompile overwrote the corrupt entries: a third engine loads clean
    gen3, out3, stats3 = _serve_one(model, str(tmp_path))
    assert out3 == ref[0]
    assert stats3["aot"]["load_failures"] == 0
    assert stats3["aot"]["programs_loaded"] > 0
    assert (gen3.prefill_traces, gen3.decode_traces) == (0, 0)


def test_torn_entry_is_deleted_with_one_warning(tmp_path, caplog):
    """A payload cut short (its library's bytes missing) reads as corrupt:
    deleted with one warning, counted, and a miss."""
    store = ProgramStore(str(tmp_path))
    key = store.entry_key("decode", {}, ("sig",))
    assert store.save(key, {"paged_decode_attention": b"\x7fELF" * 64}, {"program": "decode"})
    assert store.load(key) == {"paged_decode_attention": b"\x7fELF" * 64}
    path = tmp_path / f"{key}.aotx"
    path.write_bytes(path.read_bytes()[:-10])
    with caplog.at_level("WARNING"):
        assert store.load(key) is None
    assert [r.getMessage() for r in caplog.records if r.levelname == "WARNING"][0].startswith("corrupted AOT entry")
    assert len([r for r in caplog.records if r.levelname == "WARNING"]) == 1
    assert store.load_failures == 1 and not path.exists() and not (tmp_path / f"{key}.json").exists()


def test_armed_generator_frees_without_the_collector(tmp_path, model):
    """The wrappers live in the generator's attributes and hold its methods
    weakly: dropping an armed generator frees it (and with it, on the card,
    its graphs and their buffers) at once, with no cycle for the collector."""
    import gc
    import weakref

    gen = Generator(model, _cfg(), device="cpu").enable_aot(ProgramStore(str(tmp_path))).warmup()
    ref = weakref.ref(gen)
    enabled = gc.isenabled()
    gc.disable()
    try:
        del gen
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


# ------------------------------------------------------------------ knobs / degrade


def test_unusable_store_dir_degrades_to_plain_jit(tmp_path, model):
    """An unusable directory resolves to no store (warned), and the engine
    serves as the plain one, ``stats()`` included."""
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("occupied")
    assert resolve_store(str(blocker / "sub")) is None  # warned + disabled
    gen, out, stats = _serve_one(model, str(blocker / "sub"))
    assert "aot" not in stats
    assert len(out) == _cfg().max_new_tokens


def test_env_resolution(tmp_path, monkeypatch, model):
    from unionml_tpu.defaults import serve_aot_preload as jax_serve_aot_preload
    from unionml_tpu_torch.defaults import serve_aot_preload

    monkeypatch.delenv("UNIONML_TPU_AOT_PRELOAD", raising=False)
    assert serve_aot_preload() is None
    assert resolve_store(None) is None and resolve_store(True) is None
    for value, want in (("0", None), ("1", "~/.cache/unionml_tpu/aot"), (str(tmp_path), str(tmp_path))):
        monkeypatch.setenv("UNIONML_TPU_AOT_PRELOAD", value)
        assert serve_aot_preload() == jax_serve_aot_preload() == want

    # an engine built with aot=None (the default) reads the export
    batcher = ContinuousBatcher(Generator(model, _cfg(), device="cpu"), slots=1, decode_chunk=4)
    try:
        assert batcher._aot is not None
        assert batcher._aot.root == str(tmp_path)
    finally:
        batcher.close()
    batcher = ContinuousBatcher(Generator(model, _cfg(), device="cpu"), slots=1, decode_chunk=4, aot=False)
    try:
        assert batcher._aot is None  # False wins over the export
    finally:
        batcher.close()


def test_aot_off_keeps_stats_byte_for_byte(model):
    batcher = ContinuousBatcher(Generator(model, _cfg(), device="cpu"), slots=1, decode_chunk=4)
    try:
        assert "aot" not in batcher.stats()
    finally:
        batcher.close()


def test_aot_stats_render_clean_prometheus(tmp_path):
    """The /metrics no-None-gauge contract: the aot section (counters and
    latency windows, populated or empty) renders as clean exposition."""
    from unionml_tpu_torch.observability.prometheus import render

    store = ProgramStore(str(tmp_path))
    store.note_compiled(0.5)
    store.note_loaded(0.01)
    text = render({"generation": {"aot": store.stats()}})
    assert "unionml_tpu_generation_aot_programs_loaded 1" in text
    assert 'unionml_tpu_generation_aot_load{quantile="0.99"}' in text
    assert "None" not in text
    empty = render({"generation": {"aot": ProgramStore(str(tmp_path)).stats()}})
    assert "unionml_tpu_generation_aot_programs_loaded 0" in empty
    assert "None" not in empty


# ------------------------------------------------------------------ serverless


def test_serverless_scale_to_zero_takes_the_preload_path(tmp_path, model, ref):
    """A scaled-from-zero container's ONE startup resolves the generator's
    programs from the store (zero fresh captures), and later invocations
    reuse the warmed engine without running startup again."""
    from unionml_tpu_torch.serving.serverless import lambda_handler

    _serve_one(model, str(tmp_path))  # a previous process populated the store

    class _Server:
        async def dispatch_with_headers(self, method, path, body, headers):
            return 200, {"ok": True}, "application/json", {}

    class _Serving:
        def __init__(self):
            self._started = False
            self.server = _Server()
            self.batcher = None

        def startup(self):
            if self._started:
                return
            gen = Generator(model, _cfg(), device="cpu")
            self.batcher = ContinuousBatcher(gen, slots=2, decode_chunk=4, aot=str(tmp_path))
            self.batcher.warmup()
            self._started = True

    serving = _Serving()
    handler = lambda_handler(serving)
    event = {"httpMethod": "GET", "path": "/health"}
    try:
        assert handler(event, None)["statusCode"] == 200
        gen = serving.batcher.gen
        assert (gen.prefill_traces, gen.decode_traces) == (0, 0)  # restored, not compiled
        stats = serving.batcher.stats()["aot"]
        assert stats["programs_compiled"] == 0 and stats["programs_loaded"] > 0
        assert handler(event, None)["statusCode"] == 200
        assert handler.stats == {"invocations": 2, "startups": 1, "cold_start_s": handler.stats["cold_start_s"]}
        assert serving.batcher.gen is gen  # the warmed engine was reused, not rebuilt
        assert _drain(serving.batcher.submit(PROMPT)) == ref[0]
    finally:
        if serving.batcher is not None:
            serving.batcher.close()


# ------------------------------------------------------------------ elastic scale-up


def test_meshless_scale_up_reuses_store_on_revisited_device(tmp_path, model, ref):
    """scale down, then up: the rejoining replica's new Generator resolves
    every program from the store (no fresh capture) and serves JAX's
    tokens; the fleet sums the replicas' store counters."""
    from unionml_tpu_torch.serving import ReplicaSet

    rs = ReplicaSet.build(model, _cfg(), replicas=2, devices=["cpu"], slots=2, decode_chunk=4, aot=str(tmp_path))
    try:
        rs.warmup()
        assert rs.scale_to(1) == 1
        assert rs.scale_to(2) == 2
        new_engine = rs.batchers[1]
        assert (new_engine.gen.prefill_traces, new_engine.gen.decode_traces) == (0, 0)
        stats = new_engine.stats()["aot"]
        assert stats["programs_compiled"] == 0 and stats["programs_loaded"] > 0
        assert _drain(new_engine.submit(PROMPT)) == ref[0]
        assert (new_engine.gen.prefill_traces, new_engine.gen.decode_traces) == (0, 0)
        assert rs.stats()["aot"]["programs_loaded"] > 0  # fleet-wide aggregation
    finally:
        rs.close()


def test_speculative_engine_arms_the_draft(tmp_path, model, tiny, ref):
    """Over a drafted ``Generator`` the engine arms the draft's programs too
    (under the draft's own context), as the JAX engine does: its streams
    stay the plain greedy ones, and a second engine loads both models'
    programs."""
    import dataclasses

    from unionml_tpu_torch.models import DraftSpec

    _, _, cfg, _ = tiny
    draft = Llama(dataclasses.replace(cfg, n_layers=1), device="cpu", seed=1)
    drafted = _cfg(draft=DraftSpec(module=draft, gamma=2))
    _, out, stats = _serve_one(model, str(tmp_path), cfg=drafted)
    assert out == ref[0] and stats["aot"]["programs_compiled"] > 0
    configs = {e["context"]["module_config"] for e in ProgramStore(str(tmp_path)).entries() if e["program"] == "prefill"}
    assert len(configs) == 2  # the target's and the draft's
    _, again, stats2 = _serve_one(model, str(tmp_path), cfg=drafted)
    assert again == ref[0]
    assert stats2["aot"]["programs_compiled"] == 0 and stats2["aot"]["programs_loaded"] > 0


# ------------------------------------------------------------------ the graph route's buffers


@pytest.fixture
def graph_seam(monkeypatch):
    """Admit CPU tensors to the graph route through the module's seams: each
    graph is a tape of aten ops (``tests/torch_graph_tape.py``)."""
    for name in ("_capturable", "_begin_graph", "_end_graph"):
        monkeypatch.setattr(aot, name, getattr(aot, name))
    return torch_graph_tape.install(aot)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_graph_route_streams_equal_the_eager_engine(tmp_path, model, ref, graph_seam, paged):
    """Concurrent greedy streams through replayed programs equal JAX's plain
    ``Generator`` (the decode writes its cache in place through the bound
    pool; prefill rows after the first are copied in and out), and a seeded
    ``temperature=0.8`` stream equals the eager engine's token for token
    (each replay takes the request's generator state and gives it back)."""
    kw = dict(block_size=4) if paged else {}
    _, greedy, stats = _serve_one(model, str(tmp_path), PROMPTS, concurrent=True, **kw)
    assert greedy == ref and stats["aot"]["programs_compiled"] > 0
    assert graph_seam, "nothing went through the graph route"
    assert all(e["graph"] for e in ProgramStore(str(tmp_path)).entries() if e["program"] in ("prefill", "decode"))

    sampled = _cfg(temperature=0.8, top_k=20)
    _, got, _ = _serve_one(model, str(tmp_path / "sampled"), PROMPTS, cfg=sampled, **kw)
    eager = Generator(model, sampled, device="cpu")
    engine = ContinuousBatcher(eager, slots=2, decode_chunk=4, aot=False, **kw)
    try:
        engine.warmup()
        want = _streams(engine, PROMPTS, concurrent=False)
    finally:
        engine.close()
    assert got == want


def test_captured_launches_count_once_per_call(tmp_path, graph_seam):
    """A launch counted while capturing goes to the graph's record, not to
    the wrapper; each replay adds it once. Outputs the program allocates come
    back as fresh tensors, an input it returns as the caller's own."""
    class Counter:
        launches = 0

    def program(x, bias):
        _build.count_launch(Counter, library=None)
        return x + bias, bias

    fn = AOTFunction(program, "toy", ProgramStore(str(tmp_path)), {})
    x, bias = torch.arange(4.0), torch.ones(4)
    first, same = fn(x, bias)
    assert Counter.launches == 1 and same is bias
    outs = [fn(x + i, bias)[0] for i in range(3)]
    assert Counter.launches == 4  # one per call: the capture itself counted nothing
    assert [o.tolist() for o in outs] == [(x + i + 1).tolist() for i in range(3)]
    assert len({id(o) for o in outs}) == 3  # clones: a later replay never overwrites an earlier result
    assert ProgramStore(str(tmp_path)).entries()[0]["launches"] == {"Counter.launches": 1}


def test_capture_failure_raises(tmp_path, monkeypatch):
    """A capture that fails raises: the program does not quietly run eagerly
    in its place (this call, nor the next)."""
    def refuse(device, generators, pool):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(aot, "_capturable", lambda device: device is not None)
    monkeypatch.setattr(aot, "_begin_graph", refuse)
    fn = AOTFunction(lambda x: x * 2, "toy", ProgramStore(str(tmp_path)), {})
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture of AOT program 'toy' failed"):
            fn(torch.ones(3))


LONG_PROMPTS = [PROMPTS[1], [5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3]]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_admissions_in_flight_keep_their_own_rows(tmp_path, model, tiny, graph_seam, paged):
    """Two long prompts admitted at once, their chunks interleaved
    (``admit_chunk=4, max_admissions=2, prefill_budget=8``), on an engine
    that skipped ``warmup()``: each chunk start's program is captured on the
    first admission's row cache, which that admission goes on filling while
    the other one replays the same program. Each stream still equals JAX's
    plain ``Generator``."""
    module, params, _, _ = tiny
    jax_gen = JaxGenerator(module, params, JaxGenerationConfig(**_kw()))
    want = [np.asarray(jax_gen([p]))[0].tolist() for p in LONG_PROMPTS]
    kw = dict(block_size=4) if paged else {}
    gen = Generator(model, _cfg(), device="cpu")
    batcher = ContinuousBatcher(gen, slots=2, decode_chunk=4, aot=str(tmp_path), admit_chunk=4, max_admissions=2,
                                prefill_budget=8, **kw)
    try:
        with batcher._lock:  # both wait before the engine admits either: their chunks alternate
            streams = [batcher.submit(p) for p in LONG_PROMPTS]
        got = [_drain(s) for s in streams]
    finally:
        batcher.close()
    assert graph_seam, "nothing went through the graph route"
    assert got == want
