"""Radix prefix cache: automatic cross-request KV reuse over paged blocks.

Counterpart of ``unionml_tpu/serving/prefix_cache.py``, a copy of its pure
Python (the port imports nothing of the JAX package). Chat traffic is
overwhelmingly shared-prefix traffic: the system prompt, few-shot
scaffolding and multi-turn history repeat across requests. This is a radix
tree keyed on token prefixes whose nodes own runs of **paged KV block ids**
(SGLang's RadixAttention over vLLM-style paged KV), so a request whose
prompt extends a previously seen prefix skips prefill for the cached
portion; ``ContinuousBatcher(prefix_cache=True)`` drives it.

Design:

- **block-aligned nodes**: every node holds a run of tokens whose length is a
  multiple of ``block_size`` plus the pool block ids storing those positions'
  K/V; edges split only at block boundaries (a divergence inside a block means
  that block's K/V differs, so the block itself is never shareable past the
  split). Children are keyed by their first *block* of tokens; two siblings
  may share a sub-block token prefix, which :meth:`match` still finds by scan
  so the engine can copy-on-write the partially shared tail block.
- **block refcounts**: :meth:`match` (with ``pin=True``) increments a
  per-block refcount for every block it hands out; the engine holds the pin
  while the admitting/resident stream's table references those blocks and
  :meth:`release`\\ s on finish/cancel/preempt. Refcounts live on BLOCKS, not
  nodes, so an edge split (which moves blocks between nodes) can never strand
  or double-count a pin.
- **LRU eviction under pool pressure**: :meth:`evict` removes least-recently-
  used childless nodes whose blocks are all unpinned and returns their block
  ids to the caller (the engine's ``_free_blocks`` allocator), so admission
  never deadlocks against a full cache.
- **ownership**: a block id is owned by exactly one of the engine's free
  list, a slot's private allocation, or this tree. :meth:`insert` transfers
  private blocks in (returning how many leading blocks were already present,
  i.e. NOT consumed); :meth:`evict` transfers tree blocks out.

Thread model: the tree is **externally synchronized**: every method must be
called under the owning engine's lock (``ContinuousBatcher._lock``). It keeps
no lock of its own, as eviction pushes blocks into the engine's free list
and a second lock around that hand-off would invite ordering deadlocks; the
engine's helpers that mutate it carry the ``*_locked`` suffix.

Token identity is the contract: a cached block's K/V was produced by a real
prefill of exactly the tokens the tree path spells, and prefill/decode are
deterministic functions of (tokens, positions), so serving a prefix from
cache is bit-identical to re-prefilling it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = ["RadixPrefixCache"]


@dataclasses.dataclass(eq=False)
class _Node:
    """One radix edge: a block-aligned run of tokens and the pool blocks
    holding their K/V. ``len(tokens) == len(blocks) * block_size`` always."""

    tokens: List[int]
    blocks: List[int]
    parent: Optional["_Node"]
    children: Dict[Tuple[int, ...], "_Node"] = dataclasses.field(default_factory=dict)
    last_used: int = 0


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


class RadixPrefixCache:
    """Radix tree mapping token prefixes to refcounted paged-KV block runs.

    All methods require the caller to hold the owning engine's lock (see the
    module docstring); the tree itself is plain host-side bookkeeping — no
    device work, no I/O — so the critical sections stay microseconds-short.
    """

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self._root = _Node(tokens=[], blocks=[], parent=None)
        #: per-block pin counts; a block absent from the map has refcount 0
        self._refs: Dict[int, int] = {}
        self._clock = 0
        #: structural counters (the engine folds these into its stats())
        self.evictions = 0
        self.evicted_blocks = 0

    # ------------------------------------------------------------------ queries

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _edge_for(self, node: _Node, rest: Sequence[int]) -> "Tuple[Optional[_Node], int]":
        """The child edge extending ``rest`` from ``node`` and the number of
        its tokens matched. Exact first-block matches hit the dict key; a
        sub-block match (shorter remainder, or divergence inside the first
        block) falls back to a scan so partial tail blocks are still found
        for copy-on-write reuse."""
        bs = self.block_size
        if len(rest) >= bs:
            child = node.children.get(tuple(rest[:bs]))
            if child is not None:
                return child, bs + _common_prefix(child.tokens[bs:], rest[bs:])
        best, best_c = None, 0
        for child in node.children.values():
            c = _common_prefix(child.tokens, rest)
            if c > best_c:
                best, best_c = child, c
        return best, best_c

    def match(self, tokens: Sequence[int], *, pin: bool = False) -> "Tuple[int, List[int]]":
        """Longest cached prefix of ``tokens``: returns ``(matched_tokens,
        block_ids)`` where ``block_ids`` covers positions ``[0,
        ceil(matched/block_size) * block_size)`` — the final id may be a
        partially matched block (the engine copy-on-writes it). With ``pin``
        the returned blocks' refcounts are incremented; the caller owns the
        matching :meth:`release`."""
        bs = self.block_size
        node, pos = self._root, 0
        blocks: List[int] = []
        tick = self._tick()
        while pos < len(tokens):
            child, c = self._edge_for(node, tokens[pos:])
            if child is None or c == 0:
                break
            child.last_used = tick
            blocks.extend(child.blocks[: -(-c // bs)])
            pos += c
            if c < len(child.tokens):
                break
            node = child
        if pin and blocks:
            for b in blocks:
                self._refs[b] = self._refs.get(b, 0) + 1
        return pos, blocks

    def match_len(self, tokens: Sequence[int]) -> int:
        """Cheap routing probe: matched token count without pinning (and
        without LRU updates — a probe that loses the routing race must not
        refresh recency on a replica that never serves the request)."""
        node, pos = self._root, 0
        while pos < len(tokens):
            child, c = self._edge_for(node, tokens[pos:])
            if child is None or c == 0:
                break
            pos += c
            if c < len(child.tokens):
                break
            node = child
        return pos

    # ------------------------------------------------------------------ pins

    def pin(self, block_ids: Sequence[int]) -> None:
        """Increment the given blocks' refcounts (e.g. the engine's static
        shared-prefix blocks, pinned permanently at construction)."""
        for b in block_ids:
            self._refs[b] = self._refs.get(b, 0) + 1

    def release(self, block_ids: Sequence[int]) -> None:
        """Decrement refcounts taken by :meth:`match`/:meth:`pin`."""
        for b in block_ids:
            left = self._refs.get(b, 0) - 1
            if left > 0:
                self._refs[b] = left
            else:
                self._refs.pop(b, None)

    def pinned_blocks(self) -> int:
        return len(self._refs)

    # ------------------------------------------------------------------ insert

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Insert the block-aligned run ``tokens`` (``len == len(blocks) *
        block_size``) whose K/V lives in ``blocks``. Walks the existing tree;
        already-present leading blocks are kept (the tree's copy wins — a
        concurrent admission may have inserted the same prefix first) and the
        remainder's blocks transfer into the tree. Returns the number of
        leading blocks NOT consumed: the caller retains ownership of exactly
        ``blocks[:returned]`` and has transferred ``blocks[returned:]``."""
        bs = self.block_size
        if len(tokens) != len(blocks) * bs:
            raise ValueError(
                f"insert needs block-aligned tokens: {len(tokens)} tokens vs "
                f"{len(blocks)} blocks of {bs}"
            )
        node, pos = self._root, 0
        tick = self._tick()
        while pos < len(tokens):
            rest = tokens[pos:]
            child = node.children.get(tuple(rest[:bs]))
            if child is None:
                new = _Node(
                    tokens=list(rest), blocks=list(blocks[pos // bs :]),
                    parent=node, last_used=tick,
                )
                node.children[tuple(rest[:bs])] = new
                return pos // bs
            c = _common_prefix(child.tokens, rest)
            cb = (c // bs) * bs  # splits happen at block boundaries only
            child.last_used = tick
            if cb == len(child.tokens):
                node, pos = child, pos + cb
                continue
            # divergence inside this edge past >= 1 shared block: split so the
            # shared blocks become a common parent (cb >= bs because the first
            # block matched via the dict key)
            self._split(child, cb)
            node, pos = child, pos + cb
        return pos // bs

    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s run at block-aligned token offset ``at``: the node
        keeps ``tokens[:at]`` and a new child inherits the remainder (tokens,
        blocks, children). Refcounts ride on block ids, so the move cannot
        unbalance any session's pins."""
        bs = self.block_size
        tail = _Node(
            tokens=node.tokens[at:], blocks=node.blocks[at // bs :],
            parent=node, children=node.children, last_used=node.last_used,
        )
        for grandchild in tail.children.values():
            grandchild.parent = tail
        node.tokens = node.tokens[:at]
        node.blocks = node.blocks[: at // bs]
        node.children = {tuple(tail.tokens[:bs]): tail}

    # ------------------------------------------------------------------ eviction

    def _evictable(self, node: _Node) -> bool:
        return not node.children and not any(b in self._refs for b in node.blocks)

    def _leaves(self) -> "Iterator[_Node]":
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            else:
                yield node

    def evict(self, n_blocks: int) -> List[int]:
        """Free at least ``n_blocks`` block ids by removing least-recently-used
        childless nodes whose blocks are all unpinned, cascading to parents
        that become childless. Returns the freed ids (possibly more than
        asked — eviction is node-granular — or fewer when everything left is
        pinned or an ancestor of a pinned node)."""
        freed: List[int] = []
        while len(freed) < n_blocks:
            victim: Optional[_Node] = None
            for leaf in self._leaves():
                if not self._evictable(leaf):
                    continue
                if victim is None or leaf.last_used < victim.last_used:
                    victim = leaf
            if victim is None:
                break
            parent = victim.parent
            assert parent is not None  # the root is never a leaf candidate
            parent.children.pop(tuple(victim.tokens[: self.block_size]))
            freed.extend(victim.blocks)
            self.evictions += 1
        self.evicted_blocks += len(freed)
        return freed

    def evictable_blocks(self) -> int:
        """Blocks reclaimable by repeated :meth:`evict` right now: the blocks
        of every fully unpinned subtree (a pinned descendant shields its
        ancestors — leaves-first eviction can never reach them)."""

        def removable(node: _Node) -> "Tuple[bool, int]":
            total = 0
            ok = not any(b in self._refs for b in node.blocks)
            for child in node.children.values():
                child_ok, child_total = removable(child)
                ok = ok and child_ok
                total += child_total
            return ok, (total + len(node.blocks)) if ok else total

        count = 0
        for child in self._root.children.values():
            _, reclaimable = removable(child)
            count += reclaimable
        return count

    # ------------------------------------------------------------------ stats

    def cached_blocks(self) -> int:
        return sum(len(n.blocks) for n in self._walk())

    def cached_bytes(self, block_bytes: int) -> int:
        """HBM the cached blocks pin, at the owning engine's per-block byte
        cost (``ContinuousBatcher._block_bytes`` — pool-dtype aware, so int8
        pools count their f32 scale planes). The tree itself is dtype-blind;
        the engine supplies the conversion."""
        return self.cached_blocks() * int(block_bytes)

    def cached_tokens(self) -> int:
        return sum(len(n.tokens) for n in self._walk())

    def nodes(self) -> int:
        return sum(1 for _ in self._walk())

    def _walk(self) -> "Iterator[_Node]":
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def clear(self) -> List[int]:
        """Drop every cached node (pinned or not — the caller guarantees no
        live references, e.g. the post-warmup reset) and return all block ids
        for the allocator. Refcounts are preserved for ids the caller keeps
        seeded (the static prefix blocks it re-inserts)."""
        blocks = [b for n in self._walk() for b in n.blocks]
        self._root = _Node(tokens=[], blocks=[], parent=None)
        return blocks
