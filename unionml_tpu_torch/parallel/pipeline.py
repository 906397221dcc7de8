"""Pipeline parallelism over a ``pipe`` mesh axis, counterpart of
``unionml_tpu/parallel/pipeline.py``.

The JAX package runs the whole pipeline as one SPMD computation under
``shard_map``: identical stages are stacked on a leading ``[n_stages, ...]``
parameter dim split over ``pipe``, every device applies its stage at every
tick of ``n_microbatches + n_stages - 1`` ticks, activations move
stage-to-stage with ``ppermute``, and a masked ``psum`` returns the last
stage's outputs to every device. Autodiff derives the backward pipeline.

The port runs that schedule literally, one process a rank: each rank holds
its stage's slice of the stacked leaves (leading dim 1) and runs every tick,
bubbles included (a clipped input whose output the masks drop). The
stage-0 input, the output writes and the final mask are ``torch.where``
selections on rank-dependent flags rather than Python branches, so every
rank builds the same autograd graph and its backward meets the others'
collectives (the reverse rotations of :func:`ring_permute`) in the same
order; the dropped branches get zero cotangents, so bubble ticks add
nothing to any gradient. The input passes :func:`sum_gradients` over
``pipe`` (only stage 0 reads it), and the output sum is *g*.

Stacked parameters here are nested mappings of tensors whose leaves carry
the leading stage dim, with ``/``-joined paths as in the JAX tree; a stage
is an ``nn.Module`` applied to one stage's slice through
``torch.func.functional_call``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from unionml_tpu_torch.parallel.collectives import allreduce_sum, ring_permute, sum_gradients
from unionml_tpu_torch.parallel.mesh import BATCH_AXES
from unionml_tpu_torch.parallel.sharding import P, _entry_axes, gathered

__all__ = [
    "init_stage_params",
    "pipeline_apply",
    "pipeline_rule_table",
    "sequential_stage_apply",
    "stage_call",
    "tree_map",
]


def tree_map(fn: Callable[..., Any], tree: Mapping[str, Any], *rest: Mapping[str, Any]) -> Dict[str, Any]:
    """``fn`` over the leaves of nested mappings of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, Mapping) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def _flat(tree: Mapping[str, Any], prefix: str = "", sep: str = ".") -> Dict[str, Any]:
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, Mapping):
            out.update(_flat(leaf, f"{prefix}{key}{sep}", sep))
        else:
            out[f"{prefix}{key}"] = leaf
    return out


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *owners, last = name.split(".")
        node = out
        for part in owners:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def stage_call(module: nn.Module) -> Callable[[Mapping[str, Any], torch.Tensor], torch.Tensor]:
    """``(params tree, x) -> module(x)`` with ``module``'s parameters taken
    from the tree (``torch.func.functional_call``): the ``stage_fn`` of a
    stage module."""
    from torch.func import functional_call

    return lambda params, x: functional_call(module, _flat(params), (x,))


def init_stage_params(make_stage: Callable[[], nn.Module], n_stages: int, generator: Optional[torch.Generator] = None,
                      ) -> Dict[str, Any]:
    """``n_stages`` independently initialized copies of a stage, stacked on
    a leading stage dim: a nested mapping whose structure is one stage's
    parameter tree (so each leaf's spec gains a leading ``"pipe"`` entry).
    Each copy is ``make_stage()`` filled by
    :func:`~unionml_tpu_torch.models.layers.init_weights` from
    ``generator`` in turn."""
    from unionml_tpu_torch.models.layers import init_weights

    copies = []
    for _ in range(n_stages):
        stage = make_stage()
        init_weights(stage, generator)
        copies.append({name: p.detach() for name, p in stage.named_parameters()})
    return _nest({name: torch.stack([c[name] for c in copies]) for name in copies[0]})


def sequential_stage_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params: Mapping[str, Any],
                           x: torch.Tensor) -> torch.Tensor:
    """Reference (non-pipelined) execution of stacked stages: each stage's
    slice in turn. Numerically the pipeline's, and its oracle in tests."""
    n_stages = next(iter(_flat(stage_params).values())).shape[0]
    for s in range(n_stages):
        x = stage_fn(tree_map(lambda leaf: leaf[s], stage_params), x)
    return x


def _leaf_specs(param_specs: Any, stage_params: Mapping[str, Any], axis: str) -> Dict[str, Any]:
    flat = _flat(stage_params, sep="/")
    if param_specs is None:
        return {path: None for path in flat}
    specs = _flat(param_specs, sep="/") if isinstance(param_specs, Mapping) else dict(param_specs)
    out = {}
    for path in flat:
        spec = specs.get(path)
        spec = spec if spec is not None else P(axis)
        first = spec[0] if len(spec) else None
        if axis not in _entry_axes(first):
            raise ValueError(
                f"stage param spec {spec} does not shard its leading (stage) dim over the '{axis}' axis; "
                f"stacked stage params must carry P({axis!r}, ...)"
            )
        out[path] = spec
    return out


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Mapping[str, Any],
    x: torch.Tensor,
    mesh: Any,
    *,
    n_microbatches: int,
    axis: str = "pipe",
    batch_axes: Sequence[str] = BATCH_AXES,
    param_specs: Any = None,
) -> torch.Tensor:
    """Run stacked stages as a pipelined SPMD computation over ``mesh``;
    every rank calls it alike.

    :param stage_fn: ``(one stage's params, activations [mb, ...]) ->
        activations``, shape and dtype preserving.
    :param stage_params: this rank's shards of the stacked leaves (leading
        dim 1: its stage), placed with ``P("pipe", ...)`` (see
        :func:`pipeline_rule_table`); the whole stack where ``pipe`` is 1.
    :param x: this rank's rows of the global batch (split over
        ``batch_axes``); ``rows % n_microbatches == 0``.
    :param param_specs: the specs the leaves are placed with (a nested
        mapping like ``stage_params``, or ``{"a/b": spec}``), each leading
        with ``axis``. The leaves stay sharded at rest over their
        intra-stage axes and each rank gathers its stage's leaves inside
        (the gradient goes back through the gather's transpose). Without
        them the leaves must be whole but for the stage dim.
    """
    n_stages = mesh.shape.get(axis, 1)
    if n_stages <= 1:
        return sequential_stage_apply(stage_fn, stage_params, x)
    specs = _leaf_specs(param_specs, stage_params, axis)
    present = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)
    if x.shape[0] % n_microbatches:
        raise ValueError(f"per-shard batch {x.shape[0]} (global over {present or 'no axis'}) not divisible by "
                         f"n_microbatches={n_microbatches}")
    stage = mesh.index(axis)

    def local(leaf: torch.Tensor, path: str) -> torch.Tensor:
        spec = specs[path]
        if spec is not None:  # the stage dim is this rank's; gather the rest (minor axes first)
            leaf = gathered(leaf, P(None, *spec[1:]), mesh, keep=())
        return leaf[0]

    flat = {path: local(leaf, path) for path, leaf in _flat(stage_params, sep="/").items()}
    params = _nest({path.replace("/", "."): leaf for path, leaf in flat.items()})
    x = sum_gradients(x, mesh, axis)  # only stage 0 reads it: its cotangent lives there
    mb = x.shape[0] // n_microbatches
    inputs = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    first = torch.tensor(stage == 0, device=x.device)
    last = stage == n_stages - 1
    ticks = n_microbatches + n_stages - 1
    cur = torch.zeros_like(inputs[0])
    outputs = [torch.zeros_like(inputs[0]) for _ in range(n_microbatches)]
    for t in range(ticks):
        # stage 0 injects microbatch t (clipped during the drain: bubble work the masks drop)
        h_in = torch.where(first, inputs[min(t, n_microbatches - 1)].to(cur.dtype), cur)
        y = stage_fn(params, h_in)
        out_idx = t - (n_stages - 1)  # the last stage finishes microbatch t - (S - 1) at tick t
        idx = min(max(out_idx, 0), n_microbatches - 1)
        write = torch.tensor(last and out_idx >= 0, device=x.device)
        outputs[idx] = torch.where(write, y, outputs[idx])
        if t < ticks - 1:  # the last tick's rotation would feed no tick
            cur = ring_permute(y, mesh, axis)
    out = torch.stack(outputs)
    # finished microbatches live on the last stage; a masked sum gives them to every stage
    out = allreduce_sum(torch.where(torch.tensor(last, device=x.device), out, torch.zeros_like(out)), mesh, axis)
    return out.reshape((x.shape[0],) + tuple(x.shape[1:]))


def pipeline_rule_table(
    stage_rules: Optional[Sequence[Tuple[str, P]]] = None,
    *,
    prefix: str = r"stages/",
    axis: str = "pipe",
) -> "list[Tuple[str, P]]":
    """Rule table for stacked stage params, composable with a model's other
    rules: each per-stage rule gains a leading ``pipe`` entry (stacked
    leaves have one extra leading dim), plus a ``prefix`` catch-all sharding
    just the stage dim. Pass the result (plus embed/head rules) to
    :class:`~unionml_tpu_torch.parallel.PartitionRules`."""
    rules = []
    for pattern, spec in stage_rules or []:
        # ``.*`` bridge: real paths carry module scopes between the prefix and
        # the per-stage pattern (stages/layer_0/attn/...)
        rules.append((prefix + r".*" + pattern, P(axis, *spec)))
    rules.append((prefix, P(axis)))
    return rules

