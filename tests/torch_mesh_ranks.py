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
        if "jax" in sys.modules:
            raise AssertionError("a rank imported jax: the port and this module must not")
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

    # LoRA adapters are not placed yet: refused at placement
    from unionml_tpu_torch.models import Llama, LlamaConfig

    lora = Llama(LlamaConfig.tiny(dtype=torch.float32, param_dtype=torch.float32, lora_rank=2,
                                  **payload["configs"]["llama"]), seed=0, device="cpu")
    try:
        Generator(lora, gcfg, mesh=MeshSpec(model=4).build(device="cpu"), partition_rules=llama_partition_rules())
    except NotImplementedError as exc:
        out["lora_refused"] = str(exc)
    return out


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
        build = llama if kind != "moe" else moe
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
        if case.get("prefix"):
            cached = gen.cache_prefix(case["prefix"])
            out[name] = gen(prompts, prefix=cached)
        elif case.get("beams"):
            out[name] = gen.beam_search(prompts, num_beams=case["beams"])
        elif case.get("constraint"):
            out[name] = gen(prompts, constraint=case["constraint"])
        else:
            out[name] = gen(prompts)
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

    from unionml_tpu_torch.models import ConstraintSet, GenerationConfig, Generator, compile_regex, llama_partition_rules
    from unionml_tpu_torch.parallel import MeshSpec
    from unionml_tpu_torch.serving import ContinuousBatcher, ServingConfig
    from unionml_tpu_torch.serving.compile import CompiledPredictor

    out: Dict[str, Any] = {}
    tree, config = payload["trees"]["llama"], payload["configs"]["llama"]
    for case in payload["cases"]:
        name = case["name"]
        mesh = MeshSpec(**case["spec"]).build(device="cpu")
        kw = dict(case["config"])
        if case.get("grammar"):
            texts, pattern, eos = case["grammar"]
            kw["constraints"] = ConstraintSet([compile_regex(pattern, texts, eos_id=eos)])
        gen = Generator(llama(tree, config), GenerationConfig(**kw), mesh=mesh, partition_rules=llama_partition_rules())
        batcher = ContinuousBatcher(gen, **case["engine"])
        try:
            if rank == 0:
                prompts = case["prompts"]
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

    # the engine over a data-axis mesh is still refused
    mesh = MeshSpec(data=4).build(device="cpu")
    gen = Generator(llama(tree, config), GenerationConfig(max_new_tokens=2), mesh=mesh)
    try:
        ContinuousBatcher(gen)
    except NotImplementedError as exc:
        out["data_refused"] = str(exc)

    # ServingConfig(mesh=) through CompiledPredictor: the JAX unit case
    cp = CompiledPredictor(_linear_predict, ServingConfig(bucket_sizes=[3, 6], mesh=MeshSpec(data=4, model=-1)))
    params = {"w": torch.arange(3, dtype=torch.float32)}
    res = cp(params, np.arange(9, dtype=np.float32).reshape(3, 3))
    out["compiled"] = (cp._buckets(), res.numpy(), cp.traces)
    return out


