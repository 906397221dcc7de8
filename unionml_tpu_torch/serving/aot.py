"""AOT program store, counterpart of ``unionml_tpu/serving/aot.py``: the
generator's programs ready at serve start.

**What a stored program is in PyTorch.** The JAX package serializes each
compiled XLA executable, keyed per (program, backend, mesh, config, argument
signature), so a cold process skips tracing, lowering and compiling. The port
runs eagerly: its only compile step is ``nvcc`` building the hand-written
kernels (:mod:`unionml_tpu_torch._build`), and what an eager forward pays on
every call is host time, one launch after another. So a program here is two
things:

- a **CUDA graph captured per program and signature**
  (``torch.cuda.CUDAGraph``): every kernel one call of the program launches,
  recorded once and then replayed as one graph launch. A graph pins the
  device addresses it was captured on and lives in its process: it cannot
  be serialized.
- the **kernel libraries** the program launched (``csrc/*.cu`` built by
  ``nvcc``): those can. An entry's payload (``<digest>.aotx``) holds the bytes
  of each library, checked by length and sha256 when read; its JSON sidecar
  (``<digest>.json``) holds the program's name, signature and context, its
  launches per kernel in one call (one replay), the capture's milliseconds
  and ``"graph": true`` or ``false``.

**Keys.** An entry is keyed on (program, context, signature). The store's
own context is the format version, ``torch.__version__``,
``torch.version.cuda`` and the digest of every kernel library's sources and
flags (:func:`backend_context`; a changed kernel misses, it never loads).
A program's context (the generator's ``_aot_context``) adds the device's
name, compute capability and index (:func:`device_context`: like JAX, an
entry is pinned to its device), the module's config with ``quantize`` and
the KV dtype, the generation config and a digest of the grammar tables. The
signature is the shapes, dtypes and devices of the tensor arguments, the
static arguments (``steps``), and, for a captured program, the values of
its Python scalars (a graph bakes them in; JAX keys them by type).

**Resolution** (:meth:`AOTFunction.__call__`) on CUDA tensors,
load-before-capture:

1. an in-memory graph for the signature: the inputs are copied into its
   static buffers and it replays;
2. else a store entry: its libraries are installed where the kernel loader
   looks (:func:`~unionml_tpu_torch._build.install_library`), so no ``nvcc``
   runs; the program runs once eagerly (the call's result, and the warm pass
   a capture needs) and is captured; ``programs_loaded``;
3. else the program runs once eagerly (building its kernels with ``nvcc``
   where they are not built), is captured, and its entry is written;
   ``programs_compiled`` and ``programs_serialized``.

A graph's buffers: an input the program writes in place (the KV cache, found
by its version counter moving in the eager pass) is bound where it was
captured, the capturing caller's tensor (a second copy of an engine's KV pool
could not fit beside it). The same tensor passed again costs nothing. Another
one is swapped in: the bound tensor's contents are set aside, the new one is
copied in, the graph replays, the result is copied back out, and the bound
tensor gets its contents back, so a caller that still holds it (an
admission still filling its row while another replays the same chunk
program) never sees another's writes. Every other tensor input is copied
into a static copy before a replay, unless it is that copy. One replay at a
time runs a graph. Tensors the program allocates are cloned at
each replay (a caller may hold one across the next replay); an output that
is an input comes back as the caller's tensor. A ``torch.Generator`` input
is a generator of the graph's own, registered with it
(``CUDAGraph.register_generator_state``): it takes the caller's state before
a replay and gives it back after, so a seeded sampled stream draws the
numbers its eager run draws. Launches counted during a capture (which runs
nothing) are recorded per kernel and added to the wrappers' counts at every
replay (:func:`~unionml_tpu_torch._build.recording`).

Graphs are captured in ``thread_local`` error mode (the other engines of a
replica fleet keep launching from their threads), one warm pass and capture
at a time in the process, on the device's one side stream (cuBLAS keeps a
workspace for each stream it ran on); the graphs of one owner (a
``Generator``, which one engine drives) share one memory pool, as they
replay in turn on that engine's thread. A second engine over the
same ``Generator`` replays the same graphs, copying its pool in and out.

**Programs that stay eager**: none of those the store wraps (the
generator's prefill, chunk, first-token and decode programs, and the
draft's). The engine's admission scatters and its radix gather are not
wrapped at all: they upload a block row from the host, which a graph cannot
hold, and launch no hand-written kernel, so an entry would have nothing to
carry.

**Failures.** A corrupt entry (torn, truncated, a library whose digest does
not match) is deleted with one warning and counts ``load_failures``; the
program is then compiled and its entry rewritten. A store directory that
cannot be made resolves to no store, with a warning. A capture that fails
raises: nothing quietly runs eagerly in its place.

**On CPU tensors** (only where the caller asks for the CPU) there is no
graph: entries are keyed, counted and written the same way, and the program
runs eagerly. **Over a mesh** the collectives go through gloo's host route,
which a graph cannot capture: the engine refuses ``aot=`` there.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import threading
import time
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from unionml_tpu_torch import _build, defaults
from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.metrics import LatencyWindow

__all__ = ["AOTFunction", "GraphPool", "ProgramStore", "backend_context", "device_context", "mesh_context",
           "resolve_store"]

#: store format version: bumping it orphans (never breaks) old entries
_FORMAT = 1

_MAGIC = b"UTPUAOT1"

#: one warm pass and capture at a time in the process: both run on the
#: device's one capture stream, and another thread's work there would join
#: the graph
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[Any, Any] = {}


def backend_context() -> Dict[str, Any]:
    """The process-level key parts every entry depends on: the versions
    that built it and the identity of every kernel library it may carry."""
    return {
        "format": _FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "kernels": _build.library_digests(),
    }


def device_context(device: Any) -> Dict[str, Any]:
    """The device key parts: a graph is captured for one device, so an
    entry names its model, compute capability and index."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": {"type": device.type}}
    index = device.index if device.index is not None else torch.cuda.current_device()
    return {"device": {"type": "cuda", "name": torch.cuda.get_device_name(index),
                       "capability": list(torch.cuda.get_device_capability(index)), "index": index}}


def mesh_context(mesh: Optional[Any]) -> Dict[str, Any]:
    """Mesh key parts: axis names, per-axis extents and the ranks."""
    if mesh is None:
        return {"mesh": None}
    return {
        "mesh": {
            "axis_names": list(mesh.axis_names),
            "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
            "ranks": [int(r) for r in mesh.grid.reshape(-1).tolist()],
        }
    }


def _pack(libraries: Dict[str, bytes]) -> bytes:
    names = sorted(libraries)
    header = json.dumps({n: [len(libraries[n]), hashlib.sha256(libraries[n]).hexdigest()] for n in names}).encode()
    return _MAGIC + len(header).to_bytes(8, "little") + header + b"".join(libraries[n] for n in names)


def _unpack(blob: bytes) -> Dict[str, bytes]:
    if blob[: len(_MAGIC)] != _MAGIC:
        raise ValueError("not an AOT entry")
    start = len(_MAGIC) + 8
    end = start + int.from_bytes(blob[len(_MAGIC): start], "little")
    header = json.loads(blob[start:end])
    out, offset = {}, end
    for name in sorted(header):
        size, digest = header[name]
        data = blob[offset: offset + size]
        if len(data) != size or hashlib.sha256(data).hexdigest() != digest:
            raise ValueError(f"library {name!r} is torn")
        out[name] = data
        offset += size
    if offset != len(blob):
        raise ValueError("trailing bytes after the libraries")
    return out


class ProgramStore:
    """A directory of program entries keyed by content digests.

    Layout: ``<root>/<digest>.aotx`` (the libraries a program launched) plus
    ``<root>/<digest>.json`` (the meta sidecar: program name, context,
    signature, launches, ``graph``). Writes are atomic (tmp + rename), so a
    killed process never leaves a torn entry; a read that fails deletes the
    entry and reports a miss.

    Counters feed ``stats()["aot"]`` on the continuous engine (and
    ``/metrics`` through it): programs loaded/compiled/serialized and the
    load/compile latency windows, the JAX package's key set.
    """

    def __init__(self, root: Optional[str] = None, *, context: Optional[Dict[str, Any]] = None):
        path = os.path.abspath(os.path.expanduser(root or defaults.AOT_PRELOAD_DEFAULT_DIR))
        self.disabled = False
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as exc:
            # an unwritable dir must degrade to the plain engine, not crash it
            logger.warning(f"AOT program store disabled (cannot create {path}: {exc})")
            self.disabled = True
        self.root = path
        self._context = dict(context or {})
        self._context.update(backend_context())
        self._lock = threading.Lock()
        self.programs_loaded = 0
        self.programs_compiled = 0
        self.programs_serialized = 0
        self.load_failures = 0
        self.serialize_failures = 0
        self.load_ms = LatencyWindow()
        self.compile_ms = LatencyWindow()

    # ------------------------------------------------------------------ keys

    def context_prefix(self, program: str, context: Dict[str, Any]) -> str:
        """The per-(program, context) half of the entry key, serialized once
        (an :class:`AOTFunction` hashes only the signature per call)."""
        return json.dumps({"store": self._context, "program": program, "context": context}, sort_keys=True,
                          default=repr)

    @staticmethod
    def key_for(prefix: str, signature: Any) -> str:
        return hashlib.sha256((prefix + "|" + repr(signature)).encode()).hexdigest()

    def entry_key(self, program: str, context: Dict[str, Any], signature: Any) -> str:
        """Stable digest over (store context, program name, caller context,
        argument signature): any mismatch lands on another digest, so a
        stale entry is skipped, never loaded."""
        return self.key_for(self.context_prefix(program, context), signature)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.aotx")

    def has(self, key: str) -> bool:
        return not self.disabled and os.path.exists(self._path(key))

    # ------------------------------------------------------------------ io

    def load(self, key: str) -> Optional[Dict[str, bytes]]:
        """The libraries stored for ``key`` (name to bytes), or ``None`` on a
        miss. An unreadable entry is deleted and reported as a miss with a
        warning: the caller compiles, then writes a good entry."""
        if self.disabled:
            return None
        try:
            with open(self._path(key), "rb") as fh:
                return _unpack(fh.read())
        except FileNotFoundError:
            return None
        except (OSError, ValueError) as exc:
            with self._lock:
                self.load_failures += 1
            logger.warning(f"corrupted AOT entry {key[:12]}… ({exc}); deleting and recompiling")
            self._discard(key)
            return None

    def _discard(self, key: str) -> None:
        for suffix in (".aotx", ".json"):
            try:
                os.remove(os.path.join(self.root, key + suffix))
            except OSError:
                pass

    def save(self, key: str, libraries: Dict[str, bytes], meta: Dict[str, Any]) -> bool:
        """Persist one entry atomically (payload first, sidecar after: a
        reader never sees a sidecar without its entry)."""
        if self.disabled:
            return False
        try:
            tmp = self._path(key) + f".tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as fh:
                fh.write(_pack(libraries))
            os.replace(tmp, self._path(key))
            meta_path = os.path.join(self.root, key + ".json")
            with open(meta_path + f".tmp.{os.getpid()}.{threading.get_ident()}", "w") as fh:
                json.dump({"store": self._context, **meta}, fh, indent=2, sort_keys=True, default=repr)
            os.replace(fh.name, meta_path)
        except OSError as exc:
            with self._lock:
                self.serialize_failures += 1
            logger.warning(f"could not persist AOT entry {key[:12]}… ({exc})")
            return False
        with self._lock:
            self.programs_serialized += 1
        return True

    def entries(self) -> "List[Dict[str, Any]]":
        """The meta sidecars on disk (tests and operators read these)."""
        out: "List[Dict[str, Any]]" = []
        if self.disabled:
            return out
        for name in sorted(os.listdir(self.root)):
            if not name.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.root, name)) as fh:
                    meta = json.load(fh)
            except (OSError, ValueError):
                continue
            meta["key"] = name[: -len(".json")]
            out.append(meta)
        return out

    def entry_count(self) -> int:
        if self.disabled:
            return 0
        try:
            return sum(1 for name in os.listdir(self.root) if name.endswith(".aotx"))
        except OSError:
            return 0

    # ------------------------------------------------------------------ telemetry

    def note_loaded(self, seconds: float) -> None:
        """Count one program resolved from its entry (the cold-start path)."""
        self.load_ms.observe(seconds)
        with self._lock:
            self.programs_loaded += 1

    def note_compiled(self, seconds: float) -> None:
        """Count one program resolved without an entry (the miss path)."""
        self.compile_ms.observe(seconds)
        with self._lock:
            self.programs_compiled += 1

    def note_load_failure(self, program: str, key: str, exc: BaseException) -> None:
        """An entry that read back but would not install is corrupt for this
        process: drop it so the caller compiles."""
        with self._lock:
            self.load_failures += 1
        logger.warning(f"AOT entry for {program!r} failed to install ({exc}); recompiling")
        self._discard(key)

    def stats(self) -> Dict[str, Any]:
        """``stats()["aot"]``: ints and latency windows only (the ``/metrics``
        no-None-gauge contract)."""
        with self._lock:
            out: Dict[str, Any] = {
                "programs_loaded": self.programs_loaded,
                "programs_compiled": self.programs_compiled,
                "programs_serialized": self.programs_serialized,
                "load_failures": self.load_failures,
                "serialize_failures": self.serialize_failures,
            }
        out["entries"] = self.entry_count()
        out["load_ms"] = self.load_ms.snapshot()
        out["compile_ms"] = self.compile_ms.snapshot()
        return out


def resolve_store(aot: Any, *, context: Optional[Dict[str, Any]] = None) -> Optional[ProgramStore]:
    """Normalize an ``aot=`` knob: a :class:`ProgramStore` passes through, a
    path builds one, ``True`` and ``None`` read ``UNIONML_TPU_AOT_PRELOAD``
    (the serve CLI's early export; a bare flag means the default location),
    and ``False`` is off. A store that failed to initialize resolves to
    ``None``, so the caller serves without one."""
    if aot is False:
        return None
    if isinstance(aot, ProgramStore):
        return None if aot.disabled else aot
    if aot is None or aot is True:
        path = defaults.serve_aot_preload()
        if path is None:
            return None
    else:
        path = os.fspath(aot)
    store = ProgramStore(path, context=context)
    return None if store.disabled else store


# ---------------------------------------------------------------------------- arguments


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, spec)`` of nested tuples, lists and dicts (dict order kept)."""
    if isinstance(tree, (tuple, list)):
        leaves, specs = [], []
        for item in tree:
            sub, spec = _flatten(item)
            leaves += sub
            specs.append(spec)
        return leaves, (type(tree).__name__, tuple(specs))
    if isinstance(tree, dict):
        leaves, specs = [], []
        for key, item in tree.items():
            sub, spec = _flatten(item)
            leaves += sub
            specs.append(spec)
        return leaves, ("dict", tuple(tree), tuple(specs))
    return [tree], "*"


def _unflatten(spec: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s: Any) -> Any:
        if s == "*":
            return next(it)
        if s[0] == "dict":
            return {k: build(sub) for k, sub in zip(s[1], s[2])}
        items = [build(sub) for sub in s[1]]
        return tuple(items) if s[0] == "tuple" else items

    return build(spec)


def _leaf_signature(leaf: Any, captured: bool) -> Tuple:
    """One argument leaf's part of the key: shape, dtype and device of a
    tensor or array; a Python scalar's value where a graph bakes it in, else
    its type (as JAX keys a dynamic scalar)."""
    if isinstance(leaf, torch.Tensor):
        return ("t", tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    if isinstance(leaf, torch.Generator):
        return ("g", str(leaf.device))
    if isinstance(leaf, np.ndarray):
        return ("np", tuple(leaf.shape), str(leaf.dtype))
    if leaf is None or isinstance(leaf, (bool, int, float, str)):
        return ("py", repr(leaf) if captured else type(leaf).__name__)
    return ("opaque", type(leaf).__name__)


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
                      and a.dtype == b.dtype)


class GraphPool:
    """The memory pool that one owner's graphs share (a ``Generator``'s: they
    replay in turn on its engine's thread)."""

    def __init__(self) -> None:
        self._handle: Any = None

    def handle(self) -> Any:
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


def _capture_stream(device: torch.device) -> Any:
    """The device's one side stream for warm passes and captures (caller
    holds ``_CAPTURE_LOCK``). One for the process, not one an owner: cuBLAS
    keeps a workspace for every stream it ran on, for the life of the
    process."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _Graph:
    """One captured program: its graph, one static per argument leaf (leaves
    that were one object share it), which of them it writes in place, how
    each output leaf comes back, and its launches per replay."""

    def __init__(self, graph: Any, statics: List[Any], first: List[int], mutated: List[bool], outputs: List[Tuple],
                 out_spec: Any, launches: Dict[Tuple[Any, str, Optional[str]], int]):
        self.graph, self.statics, self.mutated = graph, statics, mutated
        self.outputs, self.out_spec, self.launches = outputs, out_spec, launches
        self.distinct = [i for i, f in enumerate(first) if f == i]
        self._lock = threading.Lock()

    def replay(self, leaves: List[Any]) -> Any:
        with self._lock:
            return self._replay(leaves)

    def _replay(self, leaves: List[Any]) -> Any:
        held = []  # (bound tensor, its contents): another caller's, set aside for this replay
        for i in self.distinct:
            leaf, static = leaves[i], self.statics[i]
            if isinstance(static, torch.Tensor):
                if not _same_buffer(leaf, static):
                    if self.mutated[i]:
                        held.append((static, static.clone()))
                    static.copy_(leaf)
            elif isinstance(static, torch.Generator):
                static.set_state(leaf.get_state())
        self.graph.replay()
        for i in self.distinct:
            leaf, static = leaves[i], self.statics[i]
            if isinstance(static, torch.Tensor):
                if self.mutated[i] and not _same_buffer(leaf, static):
                    leaf.copy_(static)
            elif isinstance(static, torch.Generator):
                leaf.set_state(static.get_state())
        for static, contents in held:
            static.copy_(contents)
        _build.add_launches(self.launches)
        out = []
        for kind, value in self.outputs:
            if kind == "input":
                out.append(leaves[value])
            elif kind == "output":
                out.append(value.clone())
            else:
                out.append(value)
        return _unflatten(self.out_spec, out)


def _capturable(device: Optional[torch.device]) -> bool:
    """Whether programs on ``device`` are captured (CUDA only)."""
    return device is not None and device.type == "cuda"


def _record_graph(call: Callable[[], Any], device: torch.device, generators: List[torch.Generator],
                  pool: GraphPool) -> Tuple[Any, Any]:
    """Capture ``call()`` as a CUDA graph in the owner's pool, on the
    device's capture stream, with ``generators`` registered: ``(graph, its
    outputs)``."""
    graph = torch.cuda.CUDAGraph()
    register = getattr(graph, "register_generator_state", None)
    for generator in generators if register is not None else ():
        register(generator)
    began = False
    try:
        with torch.cuda.graph(graph, pool=pool.handle(), stream=_capture_stream(device),
                              capture_error_mode="thread_local"):
            began = True
            out = call()
    except Exception as exc:
        if began:
            _end_failed_capture(device, pool)
        if generators and register is None:
            raise NotImplementedError(
                "a captured program that draws from a torch.Generator needs CUDAGraph.register_generator_state "
                "(PyTorch 2.5 or later) to sample token for token as its eager run does; serve it without the AOT "
                "store"
            ) from exc
        raise
    return graph, out


def _end_failed_capture(device: torch.device, pool: GraphPool) -> None:
    """Undo what a failed capture left in PyTorch's allocator. Its
    ``capture_end`` raises where the capture was invalidated, before it
    stops routing the stream's allocations to the pool, and the graph never
    gives the pool back: the allocator then treats a capture as under way
    for the rest of the process and keeps every cached segment reserved
    (measured: memory freed after a failed capture stayed reserved). Stop
    the routing (an error where ``capture_end`` got that far) and drop the
    failed graph's hold on the pool."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool.handle())
    except RuntimeError:
        pass  # capture_end ended the routing before it raised
    torch._C._cuda_releasePool(index, pool.handle())


#: marks a signature resolved on CPU tensors, which run eagerly
_EAGER = object()


class AOTFunction:
    """Load-before-capture dispatch for one program (a bound method).

    Call-compatible with the wrapped function. ``static_argnames`` fold into
    the key as JAX's static arguments do. ``pool`` is the
    owner's :class:`GraphPool`; ``on_compile`` runs on every miss (a
    ``Generator`` counts its fresh captures there). See the module
    docstring for the resolution order, the buffers and the failures."""

    #: signatures resolved per wrapper: real programs have a handful (one a
    #: bucket, chunk start or decode width); past this the oldest is dropped
    _MAX_PROGRAMS = 64

    def __init__(self, fn: Callable[..., Any], program: str, store: ProgramStore, context: Dict[str, Any], *,
                 static_argnames: Tuple[str, ...] = (), pool: Optional[GraphPool] = None,
                 on_compile: Optional[Callable[[], None]] = None):
        # a bound method is held weakly: its owner keeps this wrapper in its
        # own attributes, and a cycle would keep the model, its pool and the
        # graphs alive until the collector ran
        self._method = weakref.WeakMethod(fn) if inspect.ismethod(fn) else None
        self._plain = None if self._method is not None else fn
        self.program = program
        self.store = store
        self._context = dict(context)
        self._static_argnames = tuple(static_argnames)
        self._pool = pool if pool is not None else GraphPool()
        self._on_compile = on_compile
        #: the context half of the key, serialized once: per call only the
        #: signature is hashed (this sits on the decode dispatch path)
        self._key_prefix = store.context_prefix(program, self._context)
        self._programs: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _fn(self, *args: Any, **kwargs: Any) -> Any:
        fn = self._plain if self._method is None else self._method()
        if fn is None:
            raise ReferenceError(f"the owner of AOT program {self.program!r} is gone")
        return fn(*args, **kwargs)

    def _record_event(self, source: str, ms: float) -> None:
        from unionml_tpu_torch.observability.trace import current_trace

        trace = current_trace()
        if trace is not None:
            trace.event("engine.aot_preload", program=self.program, source=source, ms=round(ms, 3))

    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        static = tuple(sorted((k, repr(v)) for k, v in kwargs.items() if k in self._static_argnames))
        dynamic = {k: v for k, v in kwargs.items() if k not in self._static_argnames}
        leaves, spec = _flatten((args, dynamic))
        device = next((leaf.device for leaf in leaves if isinstance(leaf, torch.Tensor)), None)
        captured = _capturable(device)
        ids = [id(leaf) for leaf in leaves]
        first = [ids.index(i) for i in ids]  # which leaves are one object (a table every layer holds)
        sig = (static, tuple(_leaf_signature(leaf, captured) for leaf in leaves), repr(spec), tuple(first))
        key = ProgramStore.key_for(self._key_prefix, sig)
        program = self._programs.get(key)
        if program is None:
            with self._lock:
                program = self._programs.get(key)
                if program is None:
                    return self._resolve(key, sig, device, captured, args, kwargs, leaves, spec, first)
        if program is _EAGER:
            return self._fn(*args, **kwargs)
        return program.replay(leaves)

    def _resolve(self, key: str, sig: Any, device: Optional[torch.device], captured: bool, args: Tuple,
                 kwargs: Dict[str, Any], leaves: List[Any], spec: Any, first: List[int]) -> Any:
        """The first call of a signature: run it once (from the store's
        libraries on a hit), capture it on the card, count it, and write
        the entry on a miss."""
        start = time.perf_counter()
        libraries = self.store.load(key)
        if libraries is not None:
            try:
                for name, data in libraries.items():
                    _build.install_library(name, data)
            except OSError as exc:
                self.store.note_load_failure(self.program, key, exc)
                libraries = None
        versions = [leaf._version if isinstance(leaf, torch.Tensor) else None for leaf in leaves]
        capture_ms = None
        if captured:
            with _CAPTURE_LOCK:
                with _build.recording() as warm:
                    out = self._warm(device, args, kwargs)
                mutated = [v is not None and leaf._version != v for leaf, v in zip(leaves, versions)]
                t0 = time.perf_counter()
                static_kwargs = {k: v for k, v in kwargs.items() if k in self._static_argnames}
                graph = self._capture(static_kwargs, leaves, spec, first, mutated, device)
                capture_ms = (time.perf_counter() - t0) * 1e3
            launches = graph.launches
        else:
            with _build.recording() as warm:
                out = self._fn(*args, **kwargs)
            launches = warm.launches
        elapsed = time.perf_counter() - start
        if libraries is not None:
            self.store.note_loaded(elapsed)
            self._record_event("store", elapsed * 1e3)
        else:
            self.store.note_compiled(elapsed)
            self._record_event("compile", elapsed * 1e3)
            if self._on_compile is not None:
                self._on_compile()
            self.store.save(key, {name: _build.library_bytes(name) for name in sorted(warm.libraries)}, {
                "program": self.program,
                "context": self._context,
                "signature": repr(sig),
                "graph": captured,
                "launches": {_launch_name(slot): n for slot, n in sorted(
                    launches.items(), key=lambda item: _launch_name(item[0]))},
                "capture_ms": None if capture_ms is None else round(capture_ms, 3),
                "compile_s": round(elapsed, 3),
            })
        if len(self._programs) >= self._MAX_PROGRAMS:
            self._programs.pop(next(iter(self._programs)))
        self._programs[key] = graph if captured else _EAGER
        return out

    def _warm(self, device: torch.device, args: Tuple, kwargs: Dict[str, Any]) -> Any:
        """The eager pass before a capture: on the stream the capture uses
        (where lazy state, such as cuBLAS's workspace, is made), ordered
        after the caller's work and before the caller's next. On CPU
        tensors (the tests' seam) it is the plain call."""
        if device.type != "cuda":
            return self._fn(*args, **kwargs)
        stream = _capture_stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = self._fn(*args, **kwargs)
        torch.cuda.current_stream(device).wait_stream(stream)
        return out

    def _capture(self, static_kwargs: Dict[str, Any], leaves: List[Any], spec: Any, first: List[int],
                 mutated: List[bool], device: torch.device) -> _Graph:
        """Capture one call over static buffers (see the module docstring)."""
        statics: List[Any] = []
        generators: List[torch.Generator] = []
        for i, leaf in enumerate(leaves):
            if first[i] != i:
                statics.append(statics[first[i]])
            elif isinstance(leaf, torch.Tensor):
                statics.append(leaf if mutated[i] else leaf.clone())
            elif isinstance(leaf, torch.Generator):
                generators.append(torch.Generator(device=leaf.device))
                statics.append(generators[-1])
            else:
                statics.append(leaf)
        args, dynamic = _unflatten(spec, statics)
        try:
            with _build.recording(capturing=True) as rec:
                graph, out = _record_graph(lambda: self._fn(*args, **dynamic, **static_kwargs), device, generators,
                                           self._pool)
        except NotImplementedError:
            raise
        except Exception as exc:
            raise RuntimeError(f"CUDA graph capture of AOT program {self.program!r} failed; the store does not run "
                               "it eagerly in its place") from exc
        out_leaves, out_spec = _flatten(out)
        outputs: List[Tuple] = []
        for leaf in out_leaves:
            source = next((i for i, static in enumerate(statics) if first[i] == i and (
                static is leaf or (isinstance(static, torch.Tensor) and isinstance(leaf, torch.Tensor)
                                   and _same_buffer(static, leaf)))), None)
            if source is not None:
                outputs.append(("input", source))
            elif isinstance(leaf, torch.Tensor):
                outputs.append(("output", leaf))
            else:
                outputs.append(("const", leaf))
        return _Graph(graph, statics, first, mutated, outputs, out_spec, rec.launches)


def _launch_name(slot: Tuple[Any, str, Optional[str]]) -> str:
    counter, attr, key = slot
    name = f"{getattr(counter, '__name__', type(counter).__name__)}.{attr}"
    return name if key is None else f"{name}[{key}]"
