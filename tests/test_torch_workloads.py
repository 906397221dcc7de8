"""The port's traces, scenarios and verdicts against the JAX package's.

Pure Python on both sides, so everything is held exactly: a trace the port
writes is byte for byte what JAX writes for the same requests, and each
reads the other's; ``synthesize_text`` gives JAX's bytes for all five
scenarios at seeds 0-2; ``tenant_verdicts``, ``overall_state``,
``availability`` and the replayer's ``_report`` (the clock-free part of a
replay) give JAX's dicts on the same inputs. The cases of
``tests/unit/test_workloads.py`` that cover these modules run against the
port too (the engine, tap and OpenAI cases there belong to other files).
"""

import json
import random

import pytest

from tests.test_torch_serving_units import port_cases
from unionml_tpu.workloads import SCENARIOS as JAX_SCENARIOS
from unionml_tpu.workloads import TraceRequest as JaxTraceRequest
from unionml_tpu.workloads import availability as jax_availability
from unionml_tpu.workloads import dumps_trace as jax_dumps_trace
from unionml_tpu.workloads import overall_state as jax_overall_state
from unionml_tpu.workloads import read_trace as jax_read_trace
from unionml_tpu.workloads import scenario_targets as jax_scenario_targets
from unionml_tpu.workloads import synthesize_text as jax_synthesize_text
from unionml_tpu.workloads import tenant_verdicts as jax_tenant_verdicts
from unionml_tpu.workloads import write_trace as jax_write_trace
from unionml_tpu.workloads.replayer import _Record as JaxRecord
from unionml_tpu.workloads.replayer import _report as jax_report
from unionml_tpu_torch.workloads import (
    SCENARIOS,
    TraceRequest,
    availability,
    dumps_trace,
    overall_state,
    read_trace,
    scenario_meta,
    scenario_targets,
    synthesize,
    synthesize_text,
    tenant_verdicts,
    write_trace,
)
from unionml_tpu_torch.workloads.replayer import _materialize_prompt, _Record, _report, _sse_content
from unionml_tpu_torch.workloads.traces import loads_trace

#: the unit file's cases of the trace schema, the scenarios, the replay report math and the verdicts
CASES = (
    "test_trace_round_trip_and_canonical_bytes",
    "test_trace_version_and_kind_rejected",
    "test_trace_request_validation",
    "test_synthesize_same_seed_byte_identical",
    "test_synthesize_overrides_and_unknowns",
    "test_chat_multiturn_sessions_are_linked",
    "test_report_schedule_adherence_math",
    "test_verdict_states_and_burn_rates",
    "test_verdict_min_samples_gate_and_validation",
    "test_availability_judgment_math",
)

port_cases(globals(), "test_workloads.py")
for _name in [n for n in globals() if n.startswith("test_") and n not in CASES]:
    del globals()[_name]


def _requests(cls):
    return [
        cls(t=0.5, prompt=(3, 1, 4), max_tokens=4, tenant="acme", priority="high", deadline_ms=1500.0),
        cls(t=0.25, prompt=(9, 2), max_tokens=2, session="s0", turn=0),
        cls(t=0.75, prompt=(6,), max_tokens=2, session="s0", turn=1),
        cls(t=1.0, route="/predict-stream", body={"features": [[1, 2]]}, tenant="raw"),
        cls(t=1.25, prompt_len=7, prompt_sha256="ab" * 32, route="/v1/chat/completions", stream=False),
    ]


def test_trace_bytes_equal_jax_and_each_reads_the_other(tmp_path):
    meta = {"note": "parity", "seed": 3}
    assert dumps_trace(_requests(TraceRequest), meta) == jax_dumps_trace(_requests(JaxTraceRequest), meta)
    ours, theirs = str(tmp_path / "port.ndjson"), str(tmp_path / "jax.ndjson")
    write_trace(ours, _requests(TraceRequest), meta)
    jax_write_trace(theirs, _requests(JaxTraceRequest), meta)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    meta_back, requests = read_trace(theirs)  # the JAX file in the port's reader
    jax_meta_back, jax_requests = jax_read_trace(ours)
    assert meta_back == jax_meta_back == meta
    assert [r.to_line() for r in requests] == [r.to_line() for r in jax_requests]
    assert dumps_trace(requests, meta_back) == open(theirs).read()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(JAX_SCENARIOS))
def test_synthesize_text_is_byte_equal_to_jax(name, seed):
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS)
    text = synthesize_text(name, seed)
    assert text == jax_synthesize_text(name, seed)
    assert loads_trace(text)[0] == scenario_meta(name, seed)
    assert scenario_targets(name) == jax_scenario_targets(name)
    assert [r.to_line() for r in synthesize(name, seed)] == [json.loads(line) for line in text.splitlines()[1:]]


def _per_tenant(rng):
    """A random per-tenant metrics block of the replayer's shape."""
    out = {}
    for tenant in ("a", "b", "c", "d"):
        n = rng.choice([0, 1, 3, 10])
        out[tenant] = {
            "requests": rng.randint(0, 12), "shed_ratio": rng.choice([0.0, 0.005, 0.02, 0.5]),
            "ttft_ms": {"n": n, "p95_ms": rng.uniform(10, 300)} if n else {"n": 0},
            "tbt_ms": {"n": n, "p99_ms": rng.uniform(1, 30)} if n else {"n": 0},
        }
    return out


@pytest.mark.parametrize("seed", range(6))
def test_verdicts_equal_jax(seed):
    rng = random.Random(seed)
    per_tenant = _per_tenant(rng)
    targets = {tenant: {"ttft_p95_ms": rng.uniform(50, 200), "tbt_p99_ms": rng.choice([0, 10.0, 20.0]),
                        "shed_ratio": rng.choice([0.01, 0.1])}
               for tenant in ("a", "b", "c", "e")}
    for kwargs in ({}, {"warn_factor": 1.5, "min_samples": 3}):
        verdicts = tenant_verdicts(per_tenant, targets, **kwargs)
        assert verdicts == jax_tenant_verdicts(per_tenant, targets, **kwargs)
        assert overall_state(verdicts) == jax_overall_state(verdicts)
    samples = [{"tenant": rng.choice(["a", "b", None]), "status": rng.choice([200, 200, 503, 429, None]),
                "start_s": rng.uniform(0, 3), "ttft_s": rng.choice([None, rng.uniform(0.01, 0.5)])}
               for _ in range(20)]
    faults = sorted(rng.uniform(0, 3) for _ in range(rng.randint(0, 3)))
    assert availability(samples, fault_times_s=faults, target=0.95) == jax_availability(
        samples, fault_times_s=faults, target=0.95)


def _records(cls, rng):
    records = []
    for _ in range(12):
        record = cls(rng.choice(["t1", "t2", None]))
        record.status = rng.choice([200, 200, 429, 503, 500, None])
        record.shed = record.status in (429, 503)
        record.error = record.status not in (200, 429, 503)
        record.lag_s, record.start_s = rng.uniform(0, 0.6), rng.uniform(0, 2)
        if record.status == 200:
            record.ttft_s = rng.uniform(0.01, 0.3)
            record.tbt_s = [rng.uniform(0.001, 0.05) for _ in range(rng.randint(0, 4))]
            record.tokens = len(record.tbt_s) + 1
        record.e2e_s = rng.uniform(0.01, 1.0)
        records.append(record)
    return records


@pytest.mark.parametrize("seed", range(3))
def test_report_equals_jax_on_the_same_records(seed):
    """The clock-free half of a replay: ``_report`` over the same records,
    targets, meta and fault times."""
    ours, theirs = _records(_Record, random.Random(seed)), _records(JaxRecord, random.Random(seed))
    kwargs = dict(grace_s=0.25, rate_scale=2.0, targets={"t1": {"ttft_p95_ms": 100.0, "shed_ratio": 0.1}},
                  meta={"scenario": "x", "seed": seed}, fault_times_s=[0.5, 1.5])
    assert _report(ours, 3.0, **kwargs) == jax_report(theirs, 3.0, **kwargs)


def test_materialized_prompts_and_sse_parsing_equal_jax():
    from unionml_tpu.workloads.replayer import _materialize_prompt as jax_materialize_prompt
    from unionml_tpu.workloads.replayer import _sse_content as jax_sse_content

    for port_req, jax_req in zip(_requests(TraceRequest), _requests(JaxTraceRequest)):
        if port_req.body is None:
            assert _materialize_prompt(port_req) == jax_materialize_prompt(jax_req)
    for chunk, chat in ((b'data: {"choices": [{"text": "4 5"}]}\n\n', False),
                        (b'data: {"choices": [{"delta": {"content": "7"}}], "usage": {"completion_tokens": 3}}\n\n',
                         True),
                        (b"data: [DONE]\n\n", False), (b'{"tokens": [1]}\n', False), (b"data: {bad\n\n", True)):
        assert _sse_content(chunk, chat=chat) == jax_sse_content(chunk, chat=chat)
