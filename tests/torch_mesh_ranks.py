"""Gloo worlds for the port's mesh tests, and the code their ranks run.

This module imports torch and the port only, never JAX: the ranks of a
world are spawned processes that import it, and the JAX package is held
against them from the parent pytest process (which computes the expected
values and compares what the ranks return).

:class:`World` spawns ``world`` processes (``torch.set_num_threads(1)``
each), joins them in a gloo process group through a ``FileStore`` under the
caller's temporary directory (so concurrent pytest workers never share a
rendezvous) and calls ``<target>(rank, payload)`` on every rank; its
``results()`` returns the ranks' results in rank order, raising with a
rank's traceback if any failed. The parent computes JAX's expected values
while the ranks run, spread over threads by :func:`threaded`. The rank
functions below run every case of one test file inside that one world.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import threading
import time
import traceback
from typing import Any, Dict, List

import numpy as np


def _rank_main(rank: int, world: int, store: str, target: str, payload: Any, out: Any) -> None:
    try:
        import torch
        import torch.distributed as dist

        torch.set_num_threads(1)
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world)
        try:
            result = globals()[target](rank, payload)
        finally:
            dist.destroy_process_group()
        if "jax" in sys.modules or any(m.split(".")[0] == "unionml_tpu" for m in sys.modules):
            raise AssertionError("a rank imported jax or unionml_tpu: the port and this module must not")
        out.put((rank, True, result))
    except BaseException:  # the parent reports it; the rank must not hang its queue
        out.put((rank, False, traceback.format_exc()))


class World:
    """A world of ``world`` gloo ranks running ``<target>(rank, payload)``,
    started at construction: the caller computes its expected values while
    the ranks run, then reads :meth:`results`."""

    def __init__(self, world: int, target: str, payload: Any, tmpdir: str, timeout: float = 240.0):
        ctx = multiprocessing.get_context("spawn")
        self._out = ctx.Queue()
        store = os.path.join(str(tmpdir), f"store-{target}")
        self._procs = [ctx.Process(target=_rank_main, args=(r, world, store, target, payload, self._out),
                                   daemon=True) for r in range(world)]
        for p in self._procs:
            p.start()
        self._world, self._timeout = world, timeout
        self._deadline = time.monotonic() + timeout
        self._results: Any = None

    def results(self) -> List[Any]:
        """The ranks' results in rank order (joined once), raising with a
        rank's traceback if any failed."""
        if self._results is None:
            self._results = self._join()
        return self._results

    def _join(self) -> List[Any]:
        results: Dict[int, Any] = {}
        errors = []
        try:
            while len(results) + len(errors) < self._world:
                if time.monotonic() > self._deadline:
                    errors.append(f"the world did not finish within {self._timeout} s")
                    break
                try:
                    rank, ok, value = self._out.get(timeout=2.0)
                except queue.Empty:  # a rank that died without a word ends the world
                    dead = [p.exitcode for p in self._procs if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"a rank exited with {dead} before reporting")
                        break
                    continue
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
                    break  # its peers may now wait forever in a collective
        finally:
            for p in self._procs:
                p.join(timeout=5 if errors else 30)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)
        if errors:
            raise AssertionError("\n".join(errors))
        return [results[r] for r in range(self._world)]


def threaded(jobs: Dict[Any, Any], workers: int = 4) -> Dict[Any, Any]:
    """Start ``fn()`` for each ``{key: fn}`` on a pool of ``workers`` threads
    (JAX compiles partly outside the interpreter lock) and return ``{key:
    future}``: a call that raised re-raises where its ``result()`` is read,
    in the test of that case."""
    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(workers)
    futures = {key: pool.submit(fn) for key, fn in jobs.items()}
    pool.shutdown(wait=False)
    return futures


# ---------------------------------------------------------------------------
# models from numpy trees (the parent carries the JAX weights across)


def _dtypes(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    return {**kwargs, "dtype": torch.float32, "param_dtype": torch.float32}


def llama(tree: Dict[str, Any], config: Dict[str, Any]):
    from unionml_tpu_torch.models import LlamaConfig, llama_from_jax

    return llama_from_jax(tree, LlamaConfig.tiny(**_dtypes(config)), device="cpu")


def moe(tree: Dict[str, Any], config: Dict[str, Any]):
    from unionml_tpu_torch.models import MoEConfig, moe_from_jax

    return moe_from_jax(tree, MoEConfig.tiny(**_dtypes(config)), device="cpu")


def _local_state(model) -> Dict[str, np.ndarray]:
    """Every placed leaf of a module, int8 slots as ``<kernel>.q``/``.scale``."""
    return {name: t.detach().cpu().numpy().copy() for name, t in model.state_dict().items()}


def _collect(stream) -> List[int]:
    return [int(t) for chunk in stream for t in np.atleast_1d(chunk)]


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py


def parallel_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from unionml_tpu_torch.models import Generator, GenerationConfig, llama_partition_rules, moe_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel import collectives as col

    out: Dict[str, Any] = {}
    mesh = MeshSpec(data=2, model=2).build(device="cpu")
    out["coordinate"] = dict(mesh.coordinate)
    x = torch.as_tensor(payload["x"][rank])  # [4, 6], one per rank
    for axis in ("model", "data"):
        out[f"index/{axis}"] = (col.axis_index(mesh, axis), col.axis_size(mesh, axis))
        out[f"sum/{axis}"] = col.allreduce_sum({"a": x, "b": [x * 2]}, mesh, axis)["b"][0].numpy()
        out[f"mean/{axis}"] = col.allreduce_mean(x, mesh, axis).numpy()
        for dim in (0, 1):
            out[f"gather/{axis}/{dim}"] = col.all_gather(x, mesh, axis, gather_axis=dim).numpy()
            out[f"stack/{axis}/{dim}"] = col.all_gather(x, mesh, axis, tiled=False, gather_axis=dim).numpy()
            out[f"scatter/{axis}/{dim}"] = col.reduce_scatter(x, mesh, axis, scatter_axis=dim).numpy()
        out[f"ring/{axis}"] = col.ring_permute((x, x + 1), mesh, axis)[1].numpy()
        out[f"ring2/{axis}"] = col.ring_permute(x, mesh, axis, shift=-1).numpy()
        out[f"a2a/{axis}"] = col.all_to_all(x, mesh, axis, split_axis=0, concat_axis=1).numpy()
        out[f"a2a10/{axis}"] = col.all_to_all(x, mesh, axis, split_axis=1, concat_axis=0).numpy()
        out[f"bcast/{axis}"] = col.broadcast(x, mesh, axis, src=1).numpy()
    out["host_route"] = col.host_route.count  # CPU tensors never take it
    from unionml_tpu_torch import distributed

    out["distributed"] = (distributed.is_initialized(), distributed.process_index(), distributed.process_count(),
                          distributed.agree({"from": rank}), distributed.allgather_ints(10 * rank))
    distributed.barrier("parallel")

    # placement: each rank's shards of the carried weights
    gcfg = GenerationConfig(max_new_tokens=2, temperature=0.0, prompt_buckets=(8,))
    for name, spec in payload["placements"]:
        mesh = MeshSpec(**spec).build(device="cpu")
        kind, quantize = name.split("/")
        build = llama if kind == "llama" else moe
        rules = llama_partition_rules() if kind == "llama" else moe_partition_rules()
        model = build(payload["trees"][kind], payload["configs"][kind])
        Generator(model, gcfg, mesh=mesh, partition_rules=rules, quantize=quantize or None)
        out[f"placed/{name}/{sorted(spec.items())}"] = (dict(mesh.coordinate), _local_state(model))

    # LoRA adapters are placed: each rank's adapter shards, and its greedy tokens
    lora = _seeded_lora(payload["configs"]["llama"])
    mesh = MeshSpec(model=4).build(device="cpu")
    gen = Generator(lora, gcfg, mesh=mesh, partition_rules=llama_partition_rules())
    out["lora_placed"] = (_shards(lora, "lora"), gen([[5, 6, 7], [9]]), mesh.index("model"))
    out["lora_dense"] = _biased_pair_grads()
    out["buckets"] = _bucketed_reduction()
    out["recomputed"] = _recomputed_in_another_thread()
    return out


def _seeded_lora(config: Dict[str, Any]):
    """A tiny f32 LoRA Llama from seed 0, its ``lora_b`` drawn too (seed 1)
    so the adapters change the tokens."""
    import torch

    from unionml_tpu_torch.models import Llama, LlamaConfig

    model = Llama(LlamaConfig.tiny(**_dtypes({**config, "lora_rank": 2})), seed=0, device="cpu")
    generator = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("lora_b"):
                p.normal_(0.0, 0.05, generator=generator)
    return model


def biased_pair(device: str = "cpu"):
    """A column-parallel then a row-parallel ``LoRADense`` (8 -> 16 -> 8), each
    with an adapter and a bias, from seed 0, and their rules."""
    import torch
    from torch import nn

    from unionml_tpu_torch.models.layers import LoRADense, init_weights
    from unionml_tpu_torch.parallel import P, PartitionRules

    f32 = dict(rank=2, use_bias=True, dtype=torch.float32, param_dtype=torch.float32, device=device)
    pair = nn.Sequential(LoRADense(8, 16, **f32), LoRADense(16, 8, **f32))
    generator = torch.Generator().manual_seed(0)
    init_weights(pair, generator)
    with torch.no_grad():
        for name, p in pair.named_parameters():
            if name.endswith(("lora_b", "bias")):
                p.normal_(0.0, 0.5, generator=generator)
    rules = PartitionRules([(r"^0/kernel", P("fsdp", "model")), (r"^1/kernel", P("model", "fsdp")),
                            (r"lora_a", P("fsdp", None)), (r"lora_b", P(None, "model")), (r"bias", P())])
    return pair, rules


def _biased_pair_grads() -> Dict[str, Any]:
    """The pair placed over ``fsdp=2, model=2``: its output and every rank's
    gradient shards (averaged by ``reduce_gradients`` in a reduce scope, every
    rank holding the same rows) beside the unplaced pair's on this rank."""
    import torch

    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.sharding import combine_fsdp_tp, leaf_specs, place_module, reduce_scope
    from unionml_tpu_torch.train import reduce_gradients

    x = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(2))
    whole, _ = biased_pair()
    (whole(x) ** 2).sum().backward()
    placed, rules = biased_pair()
    mesh = MeshSpec(fsdp=2, model=2).build(device="cpu")
    place_module(placed, combine_fsdp_tp(placed, mesh, rules, min_weight_size=1))
    with reduce_scope(mesh):
        y = placed(x)
        (y ** 2).sum().backward()
        reduce_gradients(placed)
    return {"y": (y.detach().numpy(), whole(x).detach().numpy()), "coordinate": dict(mesh.coordinate),
            "sizes": dict(mesh.shape), "specs": {k: tuple(v) for k, v in leaf_specs(placed).items()},
            "grads": {n: p.grad.numpy() for n, p in placed.named_parameters()},
            "whole": {n: p.grad.numpy() for n, p in whole.named_parameters()}}


def _recomputed_in_another_thread() -> Dict[str, Any]:
    """A checkpointed ``batch_mean`` loss whose backward (and so its
    recompute) runs in another thread than the one inside ``reduce_scope``,
    as autograd runs a card's backward in its device thread; beside the
    same loss not checkpointed. Each rank counts its rank + 1 entries."""
    import threading

    import torch
    import torch.distributed as dist
    from torch.utils.checkpoint import checkpoint

    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.sharding import batch_mean, reduce_scope

    mesh = MeshSpec(data=2, fsdp=2).build(device="cpu")
    den = torch.tensor(float(dist.get_rank() + 1))

    def loss(x: torch.Tensor) -> torch.Tensor:
        return batch_mean((x * x).sum(), den)

    grads = []
    for remat in (False, True):
        x = torch.arange(1.0, 4.0, requires_grad=True)
        with reduce_scope(mesh):
            value = checkpoint(loss, x, use_reentrant=False) if remat else loss(x)
            worker = threading.Thread(target=value.backward)
            worker.start()
            worker.join()
        grads.append((value.item(), x.grad.numpy()))
    return {"plain": grads[0], "remat": grads[1]}


def _bucketed_reduction() -> Dict[str, Any]:
    """``train.driver``'s in-place reduction over ``data=2, fsdp=2`` of this
    rank's gradients (drawn from its rank): at the default cap (one shared
    buffer) and at a 64-byte cap (small leaves sharing buffers, large and
    transposed ones reduced slice by slice), with the collectives counted,
    beside the mean of every rank's gradients gathered whole."""
    import torch
    import torch.distributed as dist

    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel import collectives
    from unionml_tpu_torch.train import driver

    mesh = MeshSpec(data=2, fsdp=2).build(device="cpu")
    generator = torch.Generator().manual_seed(dist.get_rank())
    shapes = [(3,), (5, 4), (2,), (40, 7), (1,)]
    grads = [torch.randn(*s, generator=generator) for s in shapes]
    grads.append(torch.randn(30, 7, generator=generator).t())  # a transposed leaf
    parts = {i: [torch.empty_like(g) for _ in range(dist.get_world_size())] for i, g in enumerate(grads)}
    for i, g in enumerate(grads):
        dist.all_gather(parts[i], g.contiguous())
    want = [torch.stack(parts[i]).mean(0).numpy() for i in range(len(grads))]
    calls = []
    raw = collectives._all_reduce_

    def counted(x: Any, group: Any) -> None:
        calls.append(x.numel())
        raw(x, group)

    collectives._all_reduce_ = counted
    try:
        out = {}
        for cap in (driver.BUCKET_BYTES, 64):
            copies = [g.clone() if g.is_contiguous() else g.clone().t().contiguous().t() for g in grads]
            previous, driver.BUCKET_BYTES = driver.BUCKET_BYTES, cap
            calls.clear()
            try:
                driver._reduce_in_place(copies, mesh, ("data", "fsdp"), 4)
            finally:
                driver.BUCKET_BYTES = previous
            out[cap] = ([c.numpy() for c in copies], list(calls), [c.is_contiguous() for c in copies])
    finally:
        collectives._all_reduce_ = raw
    return {"want": want, "by_cap": out}


# ---------------------------------------------------------------------------
# tests/test_torch_ring_attention.py


def ring_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from unionml_tpu_torch.ops.ring_attention import sequence_sharded_attention
    from unionml_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(data=1, sequence=4).build(device="cpu")
    out = {}
    for key, (q, k, v) in payload["inputs"].items():
        impl, _, causal = key
        res = sequence_sharded_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), mesh,
                                         causal=causal, impl=impl)
        out[key] = res.numpy()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_generate_tp.py


def generate_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    from unionml_tpu_torch.models import (
        ConstraintSet,
        DraftSpec,
        GenerationConfig,
        Generator,
        compile_regex,
        llama_partition_rules,
        moe_partition_rules,
    )
    from unionml_tpu_torch.parallel import MeshSpec

    out: Dict[str, Any] = {}
    for case in payload["cases"]:
        name, spec, kind = case["name"], case["spec"], case["model"]
        mesh = MeshSpec(**spec).build(device="cpu")
        build = moe if kind.startswith("moe") else llama
        model = build(payload["trees"][kind], payload["configs"][kind])
        kw = dict(case["config"])
        if case.get("grammar"):
            texts, pattern, eos = case["grammar"]
            kw["constraints"] = ConstraintSet([compile_regex(pattern, texts, eos_id=eos)])
        if case.get("draft"):
            kw["draft"] = DraftSpec(build(payload["trees"]["draft"], payload["configs"]["draft"]), gamma=3,
                                    partition_rules=llama_partition_rules())
        rules = {"llama": llama_partition_rules(), "moe": moe_partition_rules()}.get(case.get("rules"))
        gen = Generator(model, GenerationConfig(**kw), mesh=mesh, partition_rules=rules,
                        quantize=case.get("quantize"))
        prompts = case["prompts"]
        if case.get("refused"):  # the refusal's exception type, of a call and of a stream
            for key, call in ((name, lambda: gen(prompts)), (name + "/stream", lambda: list(gen.stream(prompts)))):
                try:
                    call()
                    out[key] = None
                except Exception as exc:
                    out[key], out[name + "/error"] = type(exc).__name__, str(exc)
            continue
        if case.get("prefix"):
            cached = gen.cache_prefix(case["prefix"])
            out[name] = gen(prompts, prefix=cached)
        elif case.get("beams"):
            out[name] = gen.beam_search(prompts, num_beams=case["beams"])
        elif case.get("constraint"):
            out[name] = gen(prompts, constraint=case["constraint"])
        else:
            out[name] = gen(prompts)
            if case.get("single", True):
                out[name + "/single"] = gen(prompts[:1])
            out[name + "/stream"] = np.concatenate(list(gen.stream(prompts, chunk_size=3)), axis=1)
        if case.get("draft"):
            chunks = list(gen.stream(prompts, chunk_size=3))
            out[name + "/stream"] = [np.concatenate([c[i] for c in chunks]) for i in range(len(prompts))]
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_serving_mesh.py


def _refuse_once(batcher: Any, op: str) -> None:
    """Make ``batcher``'s device operation ``op`` raise ``ValueError`` on
    its first call on this rank."""
    real, calls = getattr(batcher, op), []

    def refuse(*args: Any) -> Any:
        if not calls:
            calls.append(args)
            raise ValueError(f"{op} refused on this rank")
        return real(*args)

    setattr(batcher, op, refuse)


def _linear_predict(params: Any, features: Any) -> Any:
    return features @ params["w"]


def serving_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from unionml_tpu_torch.models import (
        ConstraintSet,
        DraftSpec,
        GenerationConfig,
        Generator,
        compile_regex,
        llama_partition_rules,
    )
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.serving import ContinuousBatcher, ServingConfig
    from unionml_tpu_torch.serving.compile import CompiledPredictor

    out: Dict[str, Any] = {}
    tree, config = payload["trees"]["llama"], payload["configs"]["llama"]

    def generator(case: Dict[str, Any], mesh: Any) -> Any:
        kw = dict(case["config"])
        if case.get("grammar"):
            texts, pattern, eos = case["grammar"]
            kw["constraints"] = ConstraintSet([compile_regex(pattern, texts, eos_id=eos)])
        if case.get("draft"):  # a draft of its own: placing it cuts the module
            kind = case.get("draft_tree", "draft")
            kw["draft"] = DraftSpec(llama(payload["trees"][kind], payload["configs"][kind]), gamma=case["draft"],
                                    partition_rules=llama_partition_rules() if case.get("draft_rules") else None)
        return Generator(llama(tree, config), GenerationConfig(**kw), device="cpu", mesh=mesh,
                         partition_rules=llama_partition_rules() if mesh is not None else None,
                         quantize=case.get("quantize"))

    def engine(case: Dict[str, Any], gen: Any) -> Any:
        knobs = dict(case["engine"])
        if case.get("prefix"):  # a collective over a mesh: every rank prefills it
            knobs["prefix"] = gen.cache_prefix(case["prefix"])
        return ContinuousBatcher(gen, **knobs)

    def spec_counters(batcher: Any, since: Any = None) -> Dict[str, Any]:
        """The engine's speculative counters, less ``since`` (the counters
        before: the Generator's speculative side, so its totals, outlive an
        engine), with ``acceptance_rate`` as ``stats()`` computes it."""
        spec = batcher._spec
        now = {"rounds": spec.rounds, "accepted": spec.accepted_tokens, "proposed": spec.proposed_tokens}
        if since is not None:
            now = {k: n - since[k] for k, n in now.items()}
        rate = round(now["accepted"] / (now["rounds"] * spec.gamma), 3) if now["rounds"] else None
        return {**now, "acceptance_rate": rate, "decode_dispatches": batcher.stats()["decode_dispatches"]}

    def one_by_one(batcher: Any, case: Dict[str, Any]) -> List[Any]:
        grammars = case.get("constraint") or [None] * len(case["prompts"])
        return [_collect(batcher.submit(p, constraint=g)) for p, g in zip(case["prompts"], grammars)]

    for case in payload["cases"]:
        name = case["name"]
        mesh = MeshSpec(**case["spec"]).build(device="cpu")
        gen = generator(case, mesh)
        batcher = engine(case, gen)
        if case.get("lockstep"):
            # every rank keeps its carried out_buf and produced after each
            # speculative dispatch: per-rank draws would part them
            real, seen = batcher._op_spec_rounds, []

            def kept(adm: Any, budget: Any, real: Any = real, seen: List[Any] = seen) -> Any:
                state = real(adm, budget)
                seen.append(tuple(batcher._carried(field, state).numpy().copy() for field in ("out_buf", "produced")))
                return state

            batcher._op_spec_rounds = kept
            out[name + "/lockstep"] = seen
        try:
            if rank == 0:
                prompts = case["prompts"]
                if case.get("sequential"):
                    # one stream at a time: each dispatch's rows, so the rounds
                    # and acceptances, do not depend on arrival times
                    out[name] = one_by_one(batcher, case)
                    out[name + "/spec"] = spec_counters(batcher)
                    solo = engine(case, generator(case, None))
                    try:
                        out[name + "/solo"] = one_by_one(solo, case)
                        out[name + "/solo_spec"] = spec_counters(solo)
                    finally:
                        solo.close()
                else:
                    streams: List[Any] = [None] * len(prompts)

                    def consume(i: int) -> None:
                        # staggered arrivals: each lands while earlier streams decode
                        time.sleep(0.03 * i)
                        kw = {"constraint": case["constraint"][i]} if case.get("constraint") else {}
                        streams[i] = _collect(batcher.submit(prompts[i], **kw))

                    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(prompts))]
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(timeout=120)
                    out[name] = streams
                if case.get("again"):
                    out[name + "/again"] = [_collect(batcher.submit(p)) for p in case["again"]]
                out[name + "/stats"] = {
                    "preemptions": batcher.preemptions,
                    "prefix_cache_hits": batcher.prefix_cache_hits,
                    "prefill_chunks": batcher.prefill_chunks,
                    "decode_dispatches": batcher.decode_dispatches,
                    "plans": batcher._plan.sent,
                }
            else:
                try:
                    batcher.submit([1, 2])
                except RuntimeError as exc:
                    out["follower_submit"] = str(exc)
        finally:
            batcher.close()
        if case.get("draft") and not case.get("lockstep") and not case.get("sequential"):
            # the prompts again one at a time on a fresh engine: each stream's
            # rounds and acceptances then depend on its prompt alone, so the
            # leader's counters must equal the JAX engine's run of the same
            # streams (a wrongly cut or wrongly prefilled draft row proposes
            # other tokens, and fewer are accepted)
            batcher = engine(case, gen)
            try:
                if rank == 0:
                    before = spec_counters(batcher)
                    out[name + "/one_by_one"] = one_by_one(batcher, case)
                    out[name + "/spec"] = spec_counters(batcher, since=before)
            finally:
                batcher.close()

    # a refusal every rank meets (a ValueError in an admission's operation,
    # before its collectives): rank 0 fails that stream and drops the rows,
    # the followers drop theirs on rank 0's word, and the engine serves on
    fault = payload["fault"]
    mesh = MeshSpec(model=4).build(device="cpu")
    gen = Generator(llama(tree, config), GenerationConfig(**fault["config"]), mesh=mesh,
                    partition_rules=llama_partition_rules())
    batcher = ContinuousBatcher(gen, **fault["engine"])
    _refuse_once(batcher, "_op_prefill_row")
    try:
        if rank == 0:
            try:
                _collect(batcher.submit(fault["prompt"]))
            except ValueError as exc:
                out["refused_together"] = str(exc)
            out["after_refusal"] = _collect(batcher.submit(fault["prompt"]))
    finally:
        batcher.close()
    # a refusal on rank 1 alone (rank 0 went on): rank 1's follower ends and
    # its close() raises, naming the admission
    batcher = ContinuousBatcher(gen, **fault["engine"])
    if rank == 1:
        _refuse_once(batcher, "_op_finalize")
    if rank == 0:
        out["alone_stream"] = _collect(batcher.submit(fault["prompt"], max_new_tokens=1))
    try:
        batcher.close()
    except RuntimeError as exc:
        out["alone"] = (str(exc), str(exc.__cause__), repr(exc.__cause__.__cause__))

    # the engine over a data-axis mesh: a process-aware replica set, each
    # rank serving the replica of its own batch slice
    mesh = MeshSpec(data=4).build(device="cpu")
    gen = Generator(llama(tree, config), GenerationConfig(**fault["config"]), mesh=mesh)
    fleet = ContinuousBatcher(gen, **fault["engine"])
    try:
        out["data_fleet"] = (type(fleet).__name__, fleet.replicas, fleet.batchers[0].gen.mesh.slice_index,
                             fleet.batchers[0].gen.mesh.devices)
        out["data_stream"] = _collect(fleet.submit(payload["cases"][0]["prompts"][rank]))
    finally:
        fleet.close()

    # a draft over a data x model mesh: a process-aware replica set of two
    # tp=2 replicas, each leader serving its slice's share of the prompts
    drafted = payload["dp_draft"]
    mesh = MeshSpec(**drafted["spec"]).build(device="cpu")
    gen = generator(drafted, mesh)
    # a call over the whole mesh first: the draft is cut to it, and the
    # delegation below gathers it back before each replica cuts its share
    out["dp_draft_call"] = gen(drafted["prompts"][:2]).tolist()
    fleet = ContinuousBatcher(gen, **drafted["engine"])
    try:
        replica = fleet.batchers[0]
        out["dp_draft_fleet"] = (type(fleet).__name__, replica.gen.mesh.slice_index, replica.gen.mesh.devices,
                                 replica._spec._draft.mesh is replica.gen.mesh,
                                 replica._spec._draft.cache_config.n_kv_heads)
        if not replica._follower:
            # one stream at a time: each leader's counters are its streams' own
            index = replica.gen.mesh.slice_index
            out["dp_draft"] = {i: _collect(fleet.submit(p)) for i, p in enumerate(drafted["prompts"])
                               if i % 2 == index}
            out["dp_draft_spec"] = spec_counters(replica)
    finally:
        fleet.close()

    # the refusals a draft keeps over a mesh, with the JAX engine's words
    refusals = payload["refusals"]
    gen = generator(refusals, MeshSpec(**refusals["spec"]).build(device="cpu"))
    said: Dict[str, str] = {}
    for label, knobs in (("prefix_cache", dict(block_size=4, prefix_cache=True)), ("role", dict(role="prefill"))):
        try:
            ContinuousBatcher(gen, **refusals["engine"], **knobs).close()
        except ValueError as exc:
            said[label] = str(exc)
    batcher = ContinuousBatcher(gen, **refusals["engine"])
    try:
        if rank == 0:
            prompt = refusals["prompts"][0]
            for label, call in (("logprobs", lambda: batcher.submit(prompt, logprobs=True)),
                                ("export_handoff", lambda: batcher.submit(prompt, export_handoff=True)),
                                ("import_handoff", lambda: batcher.import_handoff({}))):
                try:
                    call()
                except ValueError as exc:
                    said[label] = str(exc)
            said["served"] = _collect(batcher.submit(prompt))
    finally:
        batcher.close()
    out["draft_refusals"] = said

    # ServingConfig(mesh=) through CompiledPredictor: the JAX unit case
    cp = CompiledPredictor(_linear_predict, ServingConfig(bucket_sizes=[3, 6], mesh=MeshSpec(data=4, model=-1)))
    params = {"w": torch.arange(3, dtype=torch.float32)}
    res = cp(params, np.arange(9, dtype=np.float32).reshape(3, 3))
    out["compiled"] = (cp._buckets(), res.numpy(), cp.traces)
    return out




# ---------------------------------------------------------------------------
# tests/test_torch_parallel_train.py


def _lora_llama(tree: Dict[str, Any], config: Dict[str, Any], lr: float, **overrides: Any):
    """A LoRA Llama whose base is frozen (``lora_optimizer``'s labels) and
    whose adapters step by SGD: an update linear in the gradient, so the
    trained adapters hold the gradients to the JAX side's."""
    import torch

    from unionml_tpu_torch import TrainState
    from unionml_tpu_torch.models import lora_optimizer

    model = llama(tree, {**config, **overrides})
    lora_optimizer(model, lr)
    return TrainState(model, torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=lr))


def _shards(model, keyword: str) -> Dict[str, np.ndarray]:
    return {name: p.detach().numpy().copy() for name, p in model.named_parameters() if keyword in name}


def train_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from unionml_tpu_torch import TrainerConfig, evaluate, fit, make_train_step
    from unionml_tpu_torch.models import (
        bert_from_jax,
        bert_partition_rules,
        causal_lm_loss,
        chunked_causal_lm_loss,
        classification_loss,
        llama_partition_rules,
    )
    from unionml_tpu_torch.models.bert import BertConfig
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.sharding import leaf_specs, shard_slices

    out: Dict[str, Any] = {}
    tree, config = payload["tree"], payload["config"]
    for case in payload["cases"]:
        spec = case["spec"]
        state = _lora_llama(tree, config, payload["lr"], **case.get("model", {}))
        whole = _shards(state.model, "kernel")
        loss = (lambda m, b: chunked_causal_lm_loss(m, b, chunk_size=4)) if case["loss"] == "chunked" \
            else causal_lm_loss
        step = make_train_step(loss, grad_accum_steps=case.get("accum", 1))
        saves = dict(checkpoint_dir=payload["checkpoints"], checkpoint_every_steps=2) if case.get("checkpoint") else {}
        cfg = TrainerConfig(mesh=MeshSpec(**spec), partition_rules=llama_partition_rules(),
                            fsdp_min_weight_size=payload["min_weight"], log_every_steps=1, **case["trainer"], **saves)
        result = fit(state, step, case["data"], cfg, device="cpu")
        mesh = state.model.embed._mesh
        specs = leaf_specs(state.model)
        frozen = all(np.array_equal(whole[k][shard_slices(whole[k].shape, specs[k], mesh.shape, mesh.coordinate)], v)
                     for k, v in _shards(state.model, "kernel").items())
        out[case["name"]] = {
            "losses": [h["loss"] for h in result.history],
            "steps": result.steps,
            "coordinate": dict(mesh.coordinate),
            "sizes": dict(mesh.shape),
            "specs": {k: tuple(v) for k, v in specs.items()},
            "lora": _shards(state.model, "lora"),
            "frozen": frozen,
            "per_chip": (result.samples_per_sec, result.samples_per_sec_per_chip),
        }
        if saves:  # each rank resumes its own shards: nothing left to run, the trained adapters back
            import dataclasses
            import os

            fresh = _lora_llama(tree, config, payload["lr"], **case.get("model", {}))
            resumed = fit(fresh, step, case["data"], dataclasses.replace(cfg, resume=True), device="cpu")
            trained = out[case["name"]]["lora"]
            out[case["name"]]["resumed"] = (resumed.steps, all(np.array_equal(v, trained[k]) for k, v in
                                                                _shards(fresh.model, "lora").items()),
                                            sorted(os.listdir(payload["checkpoints"])))
        if case.get("evaluate"):
            out[case["name"]]["evaluate"] = evaluate(state, lambda s, b: {"loss": causal_lm_loss(s.model, b)},
                                                     case["data"], batch_size=6)

    # MoE over expert and data axes: every leaf trained by SGD
    from unionml_tpu_torch import TrainState
    from unionml_tpu_torch.models import moe_lm_loss, moe_partition_rules

    spec = payload["moe"]
    model = moe(spec["tree"], spec["config"])
    state = TrainState(model, torch.optim.SGD(model.parameters(), lr=payload["lr"]))
    cfg = TrainerConfig(mesh=MeshSpec(**spec["spec"]), partition_rules=moe_partition_rules(), log_every_steps=1,
                        **spec["trainer"])
    result = fit(state, make_train_step(moe_lm_loss), spec["data"], cfg, device="cpu")
    mesh = model.layer_0.moe.experts.wi._mesh
    out["moe"] = {"losses": [h["loss"] for h in result.history], "coordinate": dict(mesh.coordinate),
                  "sizes": dict(mesh.shape), "specs": {k: tuple(v) for k, v in leaf_specs(model).items()},
                  "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}

    # the encoders under their rules: two steps of classification_loss each
    from unionml_tpu_torch.models import ViTConfig, vit_from_jax, vit_partition_rules

    for name, build, rules in (
        ("bert", lambda p: bert_from_jax(p["tree"], BertConfig.tiny(**_dtypes(p["config"])), device="cpu"),
         bert_partition_rules()),
        ("vit", lambda p: vit_from_jax(p["tree"], ViTConfig.tiny(**_dtypes(p["config"])), device="cpu"),
         vit_partition_rules()),
    ):
        enc = payload[name]
        model = build(enc)
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=payload["lr"]))
        cfg = TrainerConfig(mesh=MeshSpec(**enc["spec"]), partition_rules=rules, log_every_steps=1, **enc["trainer"])
        result = fit(state, make_train_step(classification_loss, has_aux=True), enc["data"], cfg, device="cpu")
        mesh = model.layer_0.attn.q_proj._mesh
        out[name] = {"history": result.history, "coordinate": dict(mesh.coordinate), "sizes": dict(mesh.shape),
                     "specs": {k: tuple(v) for k, v in leaf_specs(model).items()},
                     "params": {n: p.detach().numpy().copy() for n, p in model.named_parameters()}}
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_pipeline_parallel.py


def toy_stage(dim: int):
    """The JAX tests' ``ToyStage``: ``x + Dense_1(tanh(Dense_0(x)))``."""
    import torch
    from torch import nn

    from unionml_tpu_torch.models.layers import LoRADense

    class ToyStage(nn.Module):
        def __init__(self):
            super().__init__()
            f32 = dict(use_bias=True, dtype=torch.float32, param_dtype=torch.float32, device="meta")
            self.Dense_0 = LoRADense(dim, 2 * dim, **f32)
            self.Dense_1 = LoRADense(2 * dim, dim, **f32)

        def forward(self, x):
            return x + self.Dense_1(torch.tanh(self.Dense_0(x)))

    return ToyStage()


def _tree(tree: Any, requires_grad: bool = True) -> Any:
    import torch

    if isinstance(tree, dict):
        return {k: _tree(v, requires_grad) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree)).requires_grad_(requires_grad)


def _requiring_grad(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(True)


def _grads(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy().copy()


def pipeline_rank(rank: int, payload: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from unionml_tpu_torch.parallel import MeshSpec, P, pipeline_apply, shard_pytree, stage_call
    from unionml_tpu_torch.parallel.sharding import NamedSharding, gathered, reduce_scope, shard_slices
    from unionml_tpu_torch.train import reduce_gradients

    out: Dict[str, Any] = {}
    stage_fn = stage_call(toy_stage(16))
    for case in payload["toy"]:
        mesh = MeshSpec(**case["spec"]).build(device="cpu")
        full = case["params"]
        specs = case.get("specs")
        flat_specs = {f"{o}/{leaf}": P(*s) for o, leaves in (specs or {}).items() for leaf, s in leaves.items()}
        default = {f"{o}/{leaf}": P("pipe") for o, leaves in full.items() for leaf in leaves}
        use = {**default, **flat_specs}
        shardings = {path: NamedSharding(mesh, spec) for path, spec in use.items()}
        params = _requiring_grad(shard_pytree(_tree(full, False), shardings))
        rows = NamedSharding(mesh, P(tuple(a for a in ("data", "fsdp") if mesh.shape[a] > 1) or None))
        x = torch.tensor(case["x"])[rows.slices(case["x"].shape)]
        with reduce_scope(mesh):
            y = pipeline_apply(stage_fn, params, x, mesh, n_microbatches=case["microbatches"],
                               param_specs={k: use[k] for k in use} if specs else None)
            (y ** 2).mean().backward()
            reduce_gradients(params, use)
        out[case["name"]] = {"coordinate": dict(mesh.coordinate), "sizes": dict(mesh.shape), "y": y.detach().numpy(),
                             "grads": _grads(params), "specs": {k: tuple(v) for k, v in use.items()}}

    # a dim split over two axes, gathered back minor axis first (the JAX order)
    mesh = MeshSpec(data=1, fsdp=2, model=2).build(device="cpu")
    whole = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    spec = P(None, ("fsdp", "model"))
    shard = whole[shard_slices(whole.shape, spec, mesh.shape, mesh.coordinate)].clone().requires_grad_(True)
    back = gathered(shard, spec, mesh, keep=())
    (back * torch.arange(32.0).reshape(4, 8)).sum().backward()
    out["two_axis"] = (back.detach().numpy(), shard.grad.numpy(), dict(mesh.coordinate))

    # ring and ulysses gradients, whole on every rank
    from unionml_tpu_torch.ops.ring_attention import sequence_sharded_attention

    for name, (spec, impl, q, k, v) in payload["sp"].items():
        mesh = MeshSpec(**spec).build(device="cpu")
        q, k, v = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
        res = sequence_sharded_attention(q, k, v, mesh, causal=True, impl=impl)
        (res ** 2).mean().backward()
        out[name] = (res.detach().numpy(), q.grad.numpy(), k.grad.numpy(), v.grad.numpy())

    # one PipelinedViT train step over pipe=2 x model=2
    from unionml_tpu_torch.models import PipelinedViT, ViTConfig, pipelined_vit_from_jax, pipelined_vit_partition_rules

    vit = payload["vit"]
    cfg = ViTConfig.tiny(**_dtypes(vit["config"]))
    model = PipelinedViT(cfg, n_stages=2, n_microbatches=2)
    mesh = MeshSpec(**vit["spec"]).build(device="cpu")
    rules = pipelined_vit_partition_rules()
    tree = pipelined_vit_from_jax(vit["tree"], cfg, 2, device="cpu")
    shardings = rules.shardings(tree, mesh)
    params = _requiring_grad(shard_pytree(tree, shardings))
    specs = {k: s.spec for k, s in shardings.items()}
    images, labels = torch.tensor(vit["images"]), torch.tensor(vit["labels"])
    from unionml_tpu_torch.parallel.pipeline import _flat

    leaves = list(_flat(params).values())
    before = [t.detach().clone() for t in leaves]
    opt = torch.optim.Adam(leaves, lr=1e-3)
    with reduce_scope(mesh):
        logits = model.apply(params, images, mesh, rules)
        loss = torch.nn.functional.cross_entropy(logits.float(), labels.long())
        loss.backward()
        reduce_gradients(params, specs)
    grads = _grads(params)
    opt.step()
    out["vit"] = {"loss": float(loss), "grads": grads, "coordinate": dict(mesh.coordinate), "sizes": dict(mesh.shape),
                  "specs": {k: tuple(v) for k, v in specs.items()},
                  "moved": max(float((a - b).abs().max()) for a, b in zip(leaves, before))}

    # a Generator over a pipe axis: the rules leave it replicated
    from unionml_tpu_torch.models import GenerationConfig, Generator, llama_partition_rules

    gen = payload["generate"]
    mesh = MeshSpec(**gen["spec"]).build(device="cpu")
    generator = Generator(llama(gen["tree"], gen["config"]), GenerationConfig(**gen["kw"]), mesh=mesh,
                          partition_rules=llama_partition_rules())
    out["generate"] = generator(gen["prompts"])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_fleet_mesh.py


def fleet_slice_rank(rank: int, slices: Any) -> Dict[str, Any]:
    """Each mesh of ``slices`` sliced at each count: the submeshes' rank
    grids, ``dp_extent``, the refusal of 3 replicas and the submeshes
    ``process_local_submeshes`` keeps; then a hybrid mesh of 2 hosts."""
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.parallel.mesh import process_local_submeshes
    from unionml_tpu_torch.serving.replicas import dp_extent, slice_mesh

    out: Dict[str, Any] = {"slices": []}
    for spec, counts in slices:
        mesh = MeshSpec(**spec).build(device="cpu")
        grids = {repr(c): [sub.grid.tolist() for sub in slice_mesh(mesh, c)] for c in counts}
        try:
            slice_mesh(mesh, 3)
            refusal = None
        except ValueError as exc:
            refusal = str(exc)
        local = [i for i, _ in process_local_submeshes(slice_mesh(mesh))]
        out["slices"].append({"extent": dp_extent(mesh), "grids": grids, "refusal": refusal, "local": local})
    hybrid = MeshSpec(dcn_data=2, model=2).build_hybrid(device="cpu")
    subs = slice_mesh(hybrid)
    out["hybrid"] = {"shape": list(hybrid.grid.shape), "ranks": [sub.grid.reshape(-1).tolist() for sub in subs],
                     "local": [i for i, _ in process_local_submeshes(subs)]}
    return out
