"""The port's multi-host fleet over a hybrid mesh, from real worker
processes, held against the JAX package on the CPU.

Four worker processes (``python -m unionml_tpu_torch.serving.cluster
SPEC``) join one gloo world, agree on the fleet config, and each builds
``ReplicaSet.build(mesh=MeshSpec(dcn_data=2, model=2).build_hybrid(),
partition_rules=llama_partition_rules())``: two hosts of two ranks, each
host one tp=2 replica whose first rank leads (scheduler and control
server) and whose second follows its step plans. This process is the
coordinator, outside the world, over loopback HTTP. The streams are held
against JAX's single-process dp=2 x tp=2 ``ReplicaSet`` on 4 emulated
devices (as ``tests/emulated/test_cluster.py::_reference_fleet_tokens``
builds it) and JAX's sequential ``Generator``, on the same weights:

- both hosts serve, and turn 2 of a conversation lands on the host whose
  radix tier holds turn 1;
- the prefill/decode split across the tp=2 hosts: the prefill host gathers
  its ranks' KV heads into one payload, the decode host scatters them;
- a host SIGKILLed (both its ranks) mid-stream, with host 0 held out of
  routing until host 1 had filled its slots, streamed one of them and
  queued one more prompt: the emitted stream ends in ``StreamInterrupted``,
  the queued one is retried on host 0 and equals the oracle, none hangs,
  and the fleet serves on the other host;
- a replacement host (a world of its own two ranks, announcing as host 1)
  is walked through probation back to live and serves identically;
- ``slice_mesh``, ``dp_extent`` and ``process_local_submeshes`` on the
  fleet's 4 ranks (before they build their replicas) equal JAX's on 4
  emulated devices, rank for device.

The references are built without the serve CLI's ``UNIONML_TPU_*``
exports, as the workers are: a test that leaves
``UNIONML_TPU_KV_CACHE_DTYPE=int8`` in this process's environment must not
turn JAX's oracle into an int8-cache run.

One world at a time: the fleet's 4 ranks, then the replacement's 2.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_continuous import _models
from unionml_tpu_torch.serving.cluster import FleetCoordinator, RemoteHost, StreamInterrupted, connect_fleet

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SHAPE = dict(vocab_size=96, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128)
PROMPTS = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8, 9], [7, 1], [6, 6, 6, 2]]
ENGINE = dict(slots=2, decode_chunk=4, block_size=8, pool_blocks=64)
GEN = dict(max_new_tokens=8, temperature=0.0, prompt_buckets=(16,))
#: meshes each fleet rank slices (at each count) before it builds its replica, for the slicing test
SLICES = [
    (dict(data=2, model=2), [None, 1]),
    (dict(dcn_data=2, model=2), [None]),
    (dict(data=4), [None, 2, 1]),
    (dict(data=2, fsdp=2), [None, 2]),
    (dict(data=2, sequence=2), [None, 1]),
    (dict(model=4), [None]),
]

#: seconds each of host 1's decode dispatches sleeps in the SIGKILL case (a stream of GEN's 8 tokens takes
#: two dispatches after its first token, so the kill lands well inside it)
SLOW_DECODE_S = 1.0

#: the app every rank builds from: the weights this process carried from
#: JAX's init, a hybrid mesh of hosts of ``tp`` ranks, the process-aware set
FLEET_APP = textwrap.dedent(
    f"""
    import os
    import time

    import torch

    from unionml_tpu_torch import distributed
    from unionml_tpu_torch.models import GenerationConfig, Llama, LlamaConfig, llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.serving import ReplicaSet


    def build_engine(prefix_cache=False, tp=2, slices=None):
        torch.set_num_threads(1)
        if slices is not None:  # the slicing checks, in the same world before the fleet's mesh
            import json

            from tests.torch_mesh_ranks import fleet_slice_rank

            rank = distributed.process_index()
            with open(os.path.join(os.path.dirname(__file__), f"slices-{{rank}}.json"), "w") as handle:
                json.dump(fleet_slice_rank(rank, slices), handle)
        config = LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, **{SHAPE!r})
        model = Llama(config, device="cpu")
        model.load_state_dict(torch.load(os.path.join(os.path.dirname(__file__), "weights.pt")))
        mesh = MeshSpec(dcn_data=distributed.process_count() // tp, model=tp).build_hybrid(device="cpu")
        fleet = ReplicaSet.build(
            model, GenerationConfig(**{GEN!r}), mesh=mesh, partition_rules=llama_partition_rules(),
            prefix_cache=prefix_cache, autoscale=False, **{ENGINE!r},
        )
        if distributed.process_index() // tp == 1:
            # host 1 decodes slowly once the SIGKILL case asks, so its streams are mid-flight at the kill
            engine = fleet.batchers[0]
            decode = engine._op_decode
            flag = os.path.join(os.path.dirname(__file__), "slow-host-1")

            def slowed(*args, **kwargs):
                if os.path.exists(flag):
                    time.sleep({SLOW_DECODE_S!r})
                return decode(*args, **kwargs)

            engine._op_decode = slowed
        return fleet
    """
)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _drain(stream):
    return [int(t) for chunk in stream for t in np.asarray(chunk).ravel()]


class _Fleet:
    """Worker processes of one or more worlds, all announcing into one
    rendezvous directory."""

    def __init__(self, tmp_path: Path):
        self.tmp_path = tmp_path
        self.fleet_dir = tmp_path / "fleet"
        self.procs = {}

    def spawn(self, world: int, *, kwargs=None, host_id=None, tag="w"):
        """``world`` ranks of a fresh world (the fleet, or a replacement)."""
        port = _free_port()
        for rank in range(world):
            spec = {"builder": "fleet_app:build_engine", "kwargs": kwargs or {}, "fleet_dir": str(self.fleet_dir)}
            if host_id is not None:
                spec["host_id"] = host_id
            spec_path = self.tmp_path / f"spec-{tag}{rank}.json"
            spec_path.write_text(json.dumps(spec))
            env = {k: v for k, v in os.environ.items() if not k.startswith("UNIONML_TPU_")}
            env.update({
                "UNIONML_TPU_COORDINATOR": f"127.0.0.1:{port}",
                "UNIONML_TPU_NUM_PROCESSES": str(world),
                "UNIONML_TPU_PROCESS_ID": str(rank),
                "CUDA_VISIBLE_DEVICES": "",
                "PYTHONPATH": os.pathsep.join([str(self.tmp_path), str(REPO)]),
            })
            log = open(self.tmp_path / f"{tag}{rank}.log", "w")
            self.procs[f"{tag}{rank}"] = (subprocess.Popen(
                [sys.executable, "-m", "unionml_tpu_torch.serving.cluster", str(spec_path)],
                env=env, stdout=log, stderr=subprocess.STDOUT, cwd=self.tmp_path,
            ), log)

    def wait_announced(self, hosts, timeout=120.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for name, (proc, _) in self.procs.items():
                if proc.poll() is not None and proc.returncode != 0:
                    raise RuntimeError(f"worker {name} exited rc={proc.returncode}:\n{self.tail_logs()}")
            if all((self.fleet_dir / f"host-{h}.json").exists() for h in hosts):
                return
            time.sleep(0.1)
        raise TimeoutError("fleet rendezvous timed out; worker logs:\n" + self.tail_logs())

    def tail_logs(self) -> str:
        out = []
        for name, (_, log) in self.procs.items():
            log.flush()
            out.append(f"--- {name} ---\n" + (self.tmp_path / f"{name}.log").read_text()[-2000:])
        return "\n".join(out)

    def kill(self, *names):
        for name in names:
            self.procs[name][0].kill()
        for name in names:
            self.procs[name][0].wait(timeout=30)

    def close(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        for proc, log in self.procs.values():
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
            log.close()


def _jax_references(jax_pair):
    """JAX's sequential oracle and its single-process dp=2 x tp=2 fleet,
    built as the workers build theirs: without the serve CLI's exports
    (``UNIONML_TPU_*``, which ``_Fleet.spawn`` strips from the workers'
    environment). A ``Generator`` reads ``UNIONML_TPU_QUANTIZE`` and
    ``UNIONML_TPU_KV_CACHE_DTYPE`` when it is built, and an earlier test in
    this process may have left one set."""
    from unionml_tpu.models import GenerationConfig, Generator, llama_partition_rules
    from unionml_tpu.parallel import MeshSpec
    from unionml_tpu.serving import ReplicaSet

    module, params = jax_pair
    with pytest.MonkeyPatch.context() as env:
        for name in [k for k in os.environ if k.startswith("UNIONML_TPU_")]:
            env.delenv(name)
        gen = Generator(module, params, GenerationConfig(**GEN))
        mesh = MeshSpec(data=2, model=2).build(devices=jax.devices()[:4])
        fleet = ReplicaSet.build(module, params, GenerationConfig(**GEN), mesh=mesh,
                                 partition_rules=llama_partition_rules(), **ENGINE)
        oracle = {tuple(p): list(map(int, gen([p])[0])) for p in PROMPTS}
    try:
        streams = [_drain(fleet.submit(p)) for p in PROMPTS]
    finally:
        fleet.close()
    return gen, oracle, streams


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The running 2-host x tp=2 fleet, its coordinator, and JAX's
    references (computed here while the ranks boot)."""
    module, params, port_model, _ = _models(SHAPE, seed=1)
    tmp = tmp_path_factory.mktemp("fleet_mesh")
    torch.save(port_model.state_dict(), tmp / "weights.pt")
    (tmp / "fleet_app.py").write_text(FLEET_APP)
    workers = _Fleet(tmp)
    workers.spawn(4, kwargs={"prefix_cache": True, "slices": SLICES})
    refs = {}
    thread = threading.Thread(target=lambda: refs.update(jax=_jax_references((module, params))))
    thread.start()
    coordinator = None
    try:
        workers.wait_announced([0, 1])
        coordinator = connect_fleet(workers.fleet_dir, num_hosts=2, timeout_s=60.0, probe_interval_s=0.2)
        thread.join()
        yield workers, coordinator, refs["jax"]
    finally:
        thread.join()
        if coordinator is not None:
            coordinator.close(shutdown_workers=True)
        workers.close()


def test_two_tp2_hosts_serve_as_the_jax_dp2_tp2_replica_set(fleet):
    """Streams routed over both hosts equal JAX's sequential oracle and its
    single-process dp=2 x tp=2 ReplicaSet; each host is one tp=2 replica
    owning its submesh; turn 2 lands on the host whose radix tier is warm;
    under host roles every stream crosses from the prefill host to the
    decode host with its pages whole."""
    workers, coordinator, (jax_gen, oracle, jax_fleet) = fleet
    logs = workers.tail_logs()
    assert "this host owns replica submeshes [0] of 2" in logs and "this host owns replica submeshes [1] of 2" in logs
    got = [_drain(coordinator.submit(p)) for p in PROMPTS]
    assert got == [oracle[tuple(p)] for p in PROMPTS] == jax_fleet
    stats = coordinator.stats()
    assert stats["live_hosts"] == 2 and stats["replicas"] == 2
    assert sum(coordinator._scheduler.stats()["submitted"]) == len(PROMPTS)

    # fleet-global prefix routing: host 1 warms a fresh conversation
    turn1 = [5, 5, 4, 4, 3, 3, 2, 2]
    reply = _drain(coordinator.hosts[1].submit(turn1))
    turn2 = list(turn1) + reply + [11, 12]
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and coordinator.hosts[1].probe(turn2)["cached"] == 0:
        time.sleep(0.05)
    assert coordinator.hosts[1].probe(turn2)["cached"] > 0
    before = list(coordinator._scheduler.stats()["submitted"])
    warm = _drain(coordinator.submit(turn2))
    assert coordinator._scheduler.stats()["submitted"][1] == before[1] + 1
    assert coordinator.hosts[1].stats()["prefix_cache"]["hits"] >= 1
    assert warm == list(map(int, jax_gen([turn2])[0]))

    # the prefill/decode split across the two tp=2 hosts (a second coordinator over the same workers: it
    # starts no reconciler, so it holds no thread; its close() would drain the engines the fleet still serves)
    split = FleetCoordinator([RemoteHost(h.address, host_id=h.host_id) for h in coordinator.hosts],
                             host_roles=["prefill", "decode"], prefill_threshold=1)
    assert split.roles == ["prefill", "decode"]
    got = [_drain(split.submit(p)) for p in PROMPTS]
    assert got == [oracle[tuple(p)] for p in PROMPTS]
    stats = split.stats()
    assert stats["handoffs_cross_host"] == len(PROMPTS)
    assert stats["handoff_transfer_ms"]["window"] == len(PROMPTS)
    host_stats = [entry["stats"] for entry in stats["hosts"]]
    assert sum((r.get("handoff") or {}).get("exported", 0) for r in host_stats[0]["per_replica"]) == len(PROMPTS)
    assert sum((r.get("handoff") or {}).get("imported", 0) for r in host_stats[1]["per_replica"]) == len(PROMPTS)


def test_killed_host_loses_no_stream_and_a_replacement_rejoins(fleet):
    """SIGKILL host 1's two ranks mid-wave. Host 0 is held out of routing
    while host 1 fills its slots (one stream read past its first chunk) and
    queues one more prompt; host 0 comes back and host 1 dies: the emitted
    stream ends in ``StreamInterrupted``, the queued one (nothing emitted)
    is retried on host 0 and equals the oracle, every stream ends, and host
    0 then serves alone. A replacement host (a fresh world of two ranks
    announcing as host 1) is walked through probation to live, and the
    fleet serves identically again."""
    workers, coordinator, (_, oracle, _) = fleet
    want = [oracle[tuple(p)] for p in PROMPTS]
    slots = ENGINE["slots"]
    (workers.tmp_path / "slow-host-1").touch()
    coordinator._live = lambda: [1]  # host 0 held out of routing
    try:
        held = [coordinator.submit(p) for p in PROMPTS[:slots]]
        first = next(held[0])
        late = coordinator.submit(PROMPTS[slots])
    finally:
        del coordinator._live
    workers.kill("w2", "w3")
    ended = []
    for stream in held + [late]:
        try:
            ended.append(_drain(stream))
        except StreamInterrupted as exc:
            ended.append(exc)
    assert len(first) >= 1
    assert isinstance(ended[0], StreamInterrupted), ended[0]
    assert ended[-1] == want[slots]
    assert all(isinstance(e, StreamInterrupted) or e == w for e, w in zip(ended, want))
    fleet_stats = coordinator.stats()["fleet"]
    assert fleet_stats["stream_retries"] >= 1 and fleet_stats["streams_interrupted"] >= 1
    assert [_drain(coordinator.submit(p)) for p in PROMPTS] == want
    assert coordinator.hosts[1].alive is False
    assert coordinator.host_census()[1]["state"] in ("suspect", "dead")

    workers.spawn(2, host_id=1, tag="r")
    deadline = time.monotonic() + 180
    while time.monotonic() < deadline and not coordinator.hosts[1].alive:
        time.sleep(0.2)
    assert coordinator.hosts[1].alive, f"state={coordinator.hosts[1].state}\n{workers.tail_logs()}"
    stats = coordinator.stats()
    assert stats["live_hosts"] == 2
    assert stats["fleet"]["host_rejoins"] >= 1 and stats["fleet"]["host_suspects"] >= 1
    assert stats["fleet"]["recovery_ms"]["window"] >= 1
    assert [_drain(coordinator.submit(p)) for p in PROMPTS] == want
    assert 1 in coordinator._probe_all(coordinator._live(), PROMPTS[0])


def test_references_ignore_a_leaked_serve_export(monkeypatch):
    """The references are the workers' configuration whatever this process's
    environment holds: with ``UNIONML_TPU_KV_CACHE_DTYPE=int8`` left set
    (``tests/unit/test_quantized_serving.py::
    test_serving_app_configure_quantization`` leaves it so in its xdist
    worker) they equal the references built with it unset. Built with it,
    JAX's oracle for ``[6, 6, 6, 2]`` reads an int8 KV cache and begins
    ``[59, 71, 58]``, not the f32 ``[92, 53, 88]`` the workers serve."""
    module, params, _, _ = _models(SHAPE, seed=1)
    monkeypatch.setenv("UNIONML_TPU_KV_CACHE_DTYPE", "int8")
    _, leaked, leaked_fleet = _jax_references((module, params))
    monkeypatch.delenv("UNIONML_TPU_KV_CACHE_DTYPE")
    _, clean, clean_fleet = _jax_references((module, params))
    assert leaked == clean and leaked_fleet == clean_fleet
    assert clean[tuple(PROMPTS[3])][:3] == [92, 53, 88]


def test_slicing_equals_the_jax_package(fleet):
    """Each of the fleet's 4 ranks (before it built its replica) sliced
    each mesh of ``SLICES``: the ``slice_mesh`` grids (ranks) equal JAX's
    device ids on 4 emulated devices, with ``dp_extent``, the refusal of a
    count that does not divide, and the submesh ``process_local_submeshes``
    keeps (the one holding the rank); the hybrid mesh lays a host's ranks
    consecutively."""
    from unionml_tpu.parallel import MeshSpec as JaxMeshSpec
    from unionml_tpu.serving.replicas import dp_extent as jax_dp_extent, slice_mesh as jax_slice_mesh

    workers = fleet[0]
    results = [json.loads((workers.tmp_path / f"slices-{rank}.json").read_text()) for rank in range(4)]
    expected = []
    for spec, counts in SLICES:
        mesh = JaxMeshSpec(**{"data": 1, **spec}).build(jax.devices()[:4])
        grids = {repr(c): [np.vectorize(lambda d: d.id)(np.asarray(s.devices)).tolist()
                           for s in jax_slice_mesh(mesh, c)] for c in counts}
        with pytest.raises(ValueError) as refusal:
            jax_slice_mesh(mesh, 3)
        expected.append((jax_dp_extent(mesh), grids, str(refusal.value)))
    for rank, res in enumerate(results):
        for (extent, grids, refusal), got in zip(expected, res["slices"]):
            assert got["extent"] == extent
            assert got["grids"] == grids
            assert got["refusal"] == refusal
            whole = grids["None"]
            assert got["local"] == [i for i, g in enumerate(whole) if rank in np.ravel(g)]
        assert res["hybrid"] == {"shape": [2, 1, 1, 1, 1, 1, 2], "ranks": [[0, 1], [2, 3]], "local": [rank // 2]}
