"""The port's replayer against the JAX package's, through each package's
``ServingApp`` on the same weights.

A tiny f32 Llama (the unit files' shape) is initialized in JAX and carried
into the port (``llama_params_from_jax``); each package serves it from a
``ContinuousBatcher`` behind its own ``ServingApp``. Then:

- ``chat_multiturn`` and ``deadline_heavy`` (seed 0) replay self-hosted
  through both apps' HTTP dispatch: every request's completion tokens are
  equal (sessions re-send their history, so turn n's prompt carries turn
  n-1's answer), and so are the per-tenant counts (requests, ok, shed,
  errors, tokens) and shed classes; the fields that follow the clock
  (TTFT/TBT/e2e windows, the schedule, the verdict states) are compared by
  key only. Every completed greedy stream equals ``engine.submit`` on its
  final prompt.
- a trace replays over a loopback socket (``--target``) against the port's
  app served on a thread, with JAX's self-hosted tokens;
- a fault plan armed on a 2-host port fleet (a ``LocalHost`` and a
  ``RemoteHost`` behind a real ``WorkerAgent``) gives the availability
  section JAX's ``test_replay_report_carries_availability_when_faults_given``
  checks, every request answered;
- the replay CLI: its two argument errors and exit code 1 on a breach.
"""

import asyncio
import contextlib
import io
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unionml_tpu.workloads.replayer as jax_replayer
import unionml_tpu_torch.workloads.replayer as replayer
from unionml_tpu.models import GenerationConfig as JaxGenerationConfig
from unionml_tpu.models import Generator as JaxGenerator
from unionml_tpu.models import Llama as JaxLlama, LlamaConfig as JaxLlamaConfig
from unionml_tpu.serving import ContinuousBatcher as JaxContinuousBatcher
from unionml_tpu.serving import ServingApp as JaxServingApp
from unionml_tpu.workloads import replay as jax_replay
from unionml_tpu.workloads import synthesize as jax_synthesize
from unionml_tpu_torch.cli import app as cli
from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig, llama_params_from_jax
from unionml_tpu_torch.serving import ContinuousBatcher, ServingApp
from unionml_tpu_torch.workloads import TraceRequest, replay, scenario_targets, synthesize, write_trace
from tests.torch_env import no_serve_exports  # noqa: F401 (autouse: no UNIONML_TPU_* export leaks in)

torch.set_num_threads(2)

SHAPE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
CFG = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(32, 128))
#: per-tenant leaves that follow the clock: compared by key only
TIMED = ("ttft_ms", "tbt_ms", "e2e_ms")
RATE = 4.0  # the schedules compressed 4x: the counts and tokens do not depend on it


@pytest.fixture(scope="module")
def pair():
    jax_cfg = JaxLlamaConfig.tiny(dtype=jnp.float32, param_dtype=jnp.float32, **SHAPE)
    module = JaxLlama(jax_cfg)
    params = module.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    cfg = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **SHAPE)
    model = Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg))
    return module, params, model


def _app(engine, app_cls):
    model = types.SimpleNamespace(artifact=object(), generation_batcher=engine, _predictor_config=None,
                                  _compiled_predictor=None, _stream_predictor=None, name="tiny")
    app = app_cls(model)
    app._started = True
    return app


def _engines(pair):
    module, params, model = pair
    return (JaxContinuousBatcher(JaxGenerator(module, params, JaxGenerationConfig(**CFG)), slots=2, max_waiting=64),
            ContinuousBatcher(Generator(model, GenerationConfig(**CFG), device="cpu"), slots=2, max_waiting=64))


@contextlib.contextmanager
def _captured(module, name):
    """Record the ``(final prompt, completion, status, shed)`` of every
    request a replayer module's request function ``name`` sends, keyed by
    the request."""
    seen = {}
    real = getattr(module, name)

    def key(request):
        return (request.t, request.tenant, request.session, request.turn)

    if name == "_drive_self_hosted":
        async def wrapped(app, request, prompt, record):
            completion = await real(app, request, prompt, record)
            seen[key(request)] = (list(prompt), list(completion), record.status, record.shed)
            return completion
    else:
        def wrapped(target, request, prompt, record):
            completion = real(target, request, prompt, record)
            seen[key(request)] = (list(prompt), list(completion), record.status, record.shed)
            return completion
    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, real)


def _counts(report):
    return {tenant: {k: v for k, v in entry.items() if k not in TIMED} for tenant, entry in report["per_tenant"].items()}


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


@pytest.fixture(scope="module")
def replays(pair):
    """Both packages' self-hosted replays of the two scenarios (seed 0):
    ``{scenario: {"jax"|"torch": (report, per-request outcomes)}}``, and the
    port engine for the ``engine.submit`` check."""
    jax_engine, engine = _engines(pair)
    apps = {"jax": (_app(jax_engine, JaxServingApp), jax_replay, jax_synthesize, jax_replayer),
            "torch": (_app(engine, ServingApp), replay, synthesize, replayer)}
    out = {}
    try:
        for scenario in ("chat_multiturn", "deadline_heavy"):
            out[scenario] = {}
            for name, (app, run, synth, module) in apps.items():
                with _captured(module, "_drive_self_hosted") as seen:
                    report = run(synth(scenario, 0), app=app, rate_scale=RATE, targets=scenario_targets(scenario))
                out[scenario][name] = (report, seen)
        yield out, engine
    finally:
        jax_engine.close()
        engine.close()


@pytest.mark.parametrize("scenario", ["chat_multiturn", "deadline_heavy"])
def test_self_hosted_replay_equals_jax(replays, scenario):
    got, _ = replays
    (jax_report, jax_seen), (report, seen) = got[scenario]["jax"], got[scenario]["torch"]
    requests = synthesize(scenario, 0)
    assert report["requests"] == jax_report["requests"] == len(requests) == len(seen)
    assert report["ok"] + report["shed"] == len(requests) and report["errors"] == 0
    # every request's final prompt, completion, status and shed class
    assert seen == jax_seen
    assert _counts(report) == _counts(jax_report)
    assert _keys(report) == _keys(jax_report)
    assert set(report["verdicts"]) == set(jax_report["verdicts"]) == set(scenario_targets(scenario))
    if scenario == "deadline_heavy":  # the infeasible fraction sheds 503, the rest is answered
        assert 0 < report["shed"] < len(requests)
        assert {status for _, _, status, shed in seen.values() if shed} == {503}
    else:
        assert report["shed"] == 0
        turns = {k: v for k, v in seen.items() if k[3]}
        for (t, tenant, session, turn), (prompt, _, _, _) in turns.items():  # history re-sent
            prior = next(v for k, v in seen.items() if k[2] == session and k[3] == turn - 1)
            assert prompt[:len(prior[0]) + len(prior[1])] == prior[0] + prior[1]


def test_replayed_streams_equal_engine_submit(replays):
    got, engine = replays
    for scenario in got:
        for prompt, completion, status, _ in got[scenario]["torch"][1].values():
            if status == 200:
                budget = len(completion)
                direct = [int(t) for chunk in engine.submit(prompt, max_new_tokens=budget) for t in np.ravel(chunk)]
                assert direct == completion, (scenario, prompt)


@contextlib.contextmanager
def _served(app):
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_until_complete, args=(app.server.serve("127.0.0.1", 0),), daemon=True)
    thread.start()
    for _ in range(500):
        if app.server._server is not None and app.server._server.sockets:
            break
        time.sleep(0.01)
    try:
        yield app.server._server.sockets[0].getsockname()[1]
    finally:
        asyncio.run_coroutine_threadsafe(app.server.shutdown(drain_timeout_s=30), loop).result(timeout=60)
        thread.join(timeout=30)
        for task in asyncio.all_tasks(loop):
            task.cancel()
        loop.close()


def test_target_replay_over_a_loopback_socket_equals_jax_self_hosted(pair):
    requests = synthesize("rag_long_prompt", 0, requests=3)
    jax_engine, engine = _engines(pair)
    try:
        with _captured(jax_replayer, "_drive_self_hosted") as jax_seen:
            jax_report = jax_replay(jax_synthesize("rag_long_prompt", 0, requests=3), app=_app(jax_engine, JaxServingApp),
                                    rate_scale=RATE)
        with _served(_app(engine, ServingApp)) as port, _captured(replayer, "_drive_target_sync") as seen:
            report = replay(requests, target=f"http://127.0.0.1:{port}", rate_scale=RATE)
    finally:
        jax_engine.close()
        engine.close()
    assert report["ok"] == len(requests) == 3 and seen == jax_seen
    assert _counts(report) == _counts(jax_report)


def test_availability_under_a_fault_plan_over_a_two_host_fleet(pair):
    """JAX's ``test_replay_report_carries_availability_when_faults_given``
    over a port fleet with a plan armed: RPCs to host 1 drop for the first
    0.2 s, so the coordinator routes around it; every request is answered
    and the availability section has JAX's shape."""
    from unionml_tpu.workloads.verdicts import availability as jax_availability
    from unionml_tpu_torch.serving.cluster import FleetCoordinator, LocalHost, RemoteHost, WorkerAgent
    from unionml_tpu_torch.serving.faults import FaultEvent, FaultPlan

    _, _, model = pair
    e0, e1 = (ContinuousBatcher(Generator(model, GenerationConfig(**CFG), device="cpu"), slots=2, max_waiting=64)
              for _ in range(2))
    agent = WorkerAgent(e1, process_id=1).start()
    coordinator = FleetCoordinator([LocalHost(e0, host_id=0), RemoteHost(agent.address, host_id=1)])
    plan = FaultPlan([FaultEvent(0.0, "rpc_drop", host=1, for_s=0.2)], seed=0)
    try:
        app = _app(coordinator, ServingApp)
        requests = synthesize("chaos_fleet", 3, requests_per_tenant=2, duration_s=0.4)
        coordinator.arm_faults(plan)
        report = replay(requests, app=app, fault_times_s=plan.fault_times())
    finally:
        agent.close(close_engine=True)
        e0.close(wait=False)
        coordinator.close()
    block = report["availability"]
    assert block["requests"] == len(requests) and set(block["per_tenant"]) == {"chaos-a", "chaos-b"}
    assert block["recovery"][0]["fault_t_s"] == 0.0 and block["recovery"][0]["recovered"] == 1
    assert block["success_ratio"] == 1.0 and block["hangs"] == 0
    samples = [{"tenant": "chaos-a", "status": 200, "start_s": 0.1, "ttft_s": 0.01}]
    assert _keys(block).keys() >= _keys(jax_availability(samples, fault_times_s=[0.0])).keys()


def _run_cli(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
        try:
            cli(list(args))
            code = 0
        except SystemExit as exc:
            code = exc.code
    return code, out.getvalue()


APP_MODULE = '''
import types

from unionml_tpu_torch.models import GenerationConfig, Generator, Llama, LlamaConfig
from unionml_tpu_torch.serving import ContinuousBatcher, ServingApp

config = LlamaConfig.tiny(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
engine = ContinuousBatcher(Generator(Llama(config, device="cpu", seed=0),
                                     GenerationConfig(max_new_tokens=8, temperature=0.0, prompt_buckets=(32,)),
                                     device="cpu"), slots=2, max_waiting=64)
app = ServingApp(types.SimpleNamespace(artifact=object(), generation_batcher=engine, _predictor_config=None,
                                       _compiled_predictor=None, _stream_predictor=None, name="replay_app"))
'''


def test_replay_cli_argument_errors_and_a_breach_exits_1(tmp_path, monkeypatch):
    code, out = _run_cli(["replay", "scenario:chat_multiturn", "--target", "http://127.0.0.1:9", "--self-host", "a:b"])
    assert code == 1 and "pass exactly one of --target URL or --self-host APP" in out
    code, out = _run_cli(["replay", "scenario:chaos_fleet", "--target", "http://127.0.0.1:9",
                          "--fault-plan", '{"events": []}'])
    assert code == 1 and "--fault-plan needs --self-host" in out
    # a trace that promises chat_multiturn's tenants but sends only chat-a: chat-b is judged missing
    (tmp_path / "replay_cli_app.py").write_text(APP_MODULE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    trace = tmp_path / "one.ndjson"
    write_trace(str(trace), [TraceRequest(t=0.0, prompt=(3, 1, 4), max_tokens=3, tenant="chat-a")],
                {"scenario": "chat_multiturn", "seed": 0})
    report_path = tmp_path / "report.json"
    try:
        code, out = _run_cli(["replay", str(trace), "--self-host", "replay_cli_app:app", "--out", str(report_path)])
    finally:
        import replay_cli_app

        replay_cli_app.engine.close()
    report = json.loads(report_path.read_text())
    assert code == 1, out
    assert report["ok"] == 1 and report["verdict_state"] == "breach"
    assert report["verdicts"]["chat-a"]["state"] == "pass" and report["verdicts"]["chat-b"]["state"] == "breach"
    assert json.loads(out) == report
