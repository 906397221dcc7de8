"""Grammar-constrained (structured) decoding: regex -> token-level DFA tables.

Counterpart of ``unionml_tpu/models/structured.py``: the host compiler is a
copy of it, held array for array against the original by the tests. The
grammar is data, not control flow:

- a regex is compiled on the host to a char-level DFA (Thompson NFA + subset
  construction), then projected onto the token vocabulary: ``trans[s, t]`` is
  the DFA state after emitting token ``t`` from state ``s`` and
  ``allowed[s, t]`` whether that emission keeps the output inside the language;
- the tables ride to the device once (:meth:`ConstraintSet.device_tables`);
  inside each decode step the constraint is two gathers and a masked fill —
  ``logits`` masked by ``allowed[state]``, ``state`` advanced by
  ``trans[state, token]``. No data-dependent Python control flow per grammar.

:class:`ConstraintSet` unions several grammars into ONE table pair by
renumbering states; a row's grammar is then nothing but its start state, so
one decode step serves every grammar and per-request constraints in a
continuously-batched server cost nothing extra.

Token-level liveness: a char-level-live DFA state can still be a dead end for a
given vocabulary (no token realizes any escaping path). Tables are pruned to
token-level-live states by a backwards fixed point, so every reachable state
always has at least one allowed token (EOS counts at accepting states) — the
masked logits row can never be all ``-inf``.

Budget truncation caveat (shared by every structured-output engine): if
``max_new_tokens`` runs out before the DFA reaches an accepting state, the
emitted prefix matches a prefix of the language, not necessarily a full
sentence of it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

__all__ = [
    "TokenConstraint",
    "ConstraintSet",
    "compile_regex",
    "literal_choice",
    "json_object",
    "stop_sequences",
    "vocab_from_tokenizer",
]


# ---------------------------------------------------------------------------
# Regex AST. The supported subset: literals, escapes (\d \w \s and inverses,
# \n \t \r, escaped metachars), classes [a-z0-9_] with ranges and negation,
# '.', quantifiers * + ? {m} {m,} {m,n}, alternation |, grouping (). This is
# the regular (finite-automaton) core — no backrefs/lookarounds, which have no
# DFA and therefore no place in a fixed-shape decode step.


@dataclasses.dataclass(frozen=True)
class _CharSet:
    chars: FrozenSet[str]
    negated: bool = False

    def resolve(self, alphabet: FrozenSet[str]) -> FrozenSet[str]:
        return frozenset(alphabet - self.chars) if self.negated else self.chars


@dataclasses.dataclass(frozen=True)
class _Node:
    kind: str  # "chars" | "concat" | "alt" | "repeat"
    chars: Optional[_CharSet] = None
    children: Tuple["_Node", ...] = ()
    lo: int = 0
    hi: Optional[int] = None  # None = unbounded


_DIGITS = frozenset("0123456789")
_WORD = frozenset("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")
_ESCAPES = {
    "d": _CharSet(_DIGITS),
    "D": _CharSet(_DIGITS, negated=True),
    "w": _CharSet(_WORD),
    "W": _CharSet(_WORD, negated=True),
    "s": _CharSet(_SPACE),
    "S": _CharSet(_SPACE, negated=True),
    "n": _CharSet(frozenset("\n")),
    "t": _CharSet(frozenset("\t")),
    "r": _CharSet(frozenset("\r")),
}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str) -> ValueError:
        return ValueError(f"regex error at position {self.i} in {self.p!r}: {msg}")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        ch = self.p[self.i]
        self.i += 1
        return ch

    def parse(self) -> _Node:
        node = self.alt(depth=0)
        if self.i != len(self.p):
            raise self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self, depth: int = 1) -> _Node:
        branches = [self.concat(depth)]
        while self.peek() == "|":
            self.next()
            branches.append(self.concat(depth))
        if len(branches) == 1:
            return branches[0]
        return _Node("alt", children=tuple(branches))

    def concat(self, depth: int = 1) -> _Node:
        parts: List[_Node] = []
        while self.peek() not in (None, "|", ")"):
            # Anchors are redundant under the promised fullmatch semantics —
            # but ONLY at top-level branch edges, where a branch edge IS a
            # string edge. There `^`/`$` are no-ops (the common `^...$`
            # spelling just works). Everywhere else — mid-branch, or anywhere
            # inside a group, where a branch edge is a mid-string position
            # (e.g. `(a$)b`, `a(^b)`) — re.fullmatch semantics differ from
            # both "literal" and "no-op", so an explicit error beats silently
            # compiling a different language.
            if self.peek() == "^":
                if parts or depth > 0:
                    raise self.error(
                        "'^' anchor is only supported at the pattern start "
                        "(fullmatch makes it redundant there; use \\^ for a literal '^')"
                    )
                self.next()
                continue
            if self.peek() == "$":
                if depth > 0:
                    raise self.error(
                        "'$' anchor is only supported at the pattern end "
                        "(fullmatch makes it redundant there; use \\$ for a literal '$')"
                    )
                self.next()
                if self.peek() not in (None, "|", "$"):
                    raise self.error(
                        "'$' anchor mid-pattern never matches under fullmatch "
                        "semantics (use \\$ for a literal '$')"
                    )
                continue
            parts.append(self.repeat())
        return _Node("concat", children=tuple(parts))

    def repeat(self) -> _Node:
        node = self.atom()
        while self.peek() in ("*", "+", "?", "{"):
            ch = self.peek()
            if ch == "{":
                save = self.i
                bounds = self._brace_bounds()
                if bounds is None:
                    self.i = save
                    break  # a literal '{' with no valid quantifier body
                lo, hi = bounds
            else:
                self.next()
                lo, hi = {"*": (0, None), "+": (1, None), "?": (0, 1)}[ch]
            node = _Node("repeat", children=(node,), lo=lo, hi=hi)
        return node

    def _brace_bounds(self) -> Optional[Tuple[int, Optional[int]]]:
        """Parse ``{m}``/``{m,}``/``{m,n}``/``{,n}`` after a consumed ``{``;
        ``None`` = not a quantifier (the brace is a literal, matching how
        ``re`` treats e.g. ``a{-2}`` or ``a{ 2}``)."""
        self.next()  # consume '{'
        body = ""
        while self.peek() not in (None, "}"):
            body += self.next()
        if self.peek() != "}":
            return None
        self.next()
        # strictly (possibly empty) digits around at most one comma — int()
        # would also accept "-2" / " 2", silently compiling a different
        # language than re does. Python 3.12 semantics: {m}, {m,}, {,n}, and
        # bare {,} (= {0,}) are quantifiers; anything else is a literal brace.
        head, sep, tail = body.partition(",")
        if (head and not head.isdigit()) or (tail and not tail.isdigit()):
            return None
        if not sep:
            if not head:
                return None  # "{}" is a literal
            lo = int(head)
            return lo, lo
        lo = int(head) if head else 0
        hi = int(tail) if tail else None
        if hi is not None and hi < lo:
            raise self.error(f"bad quantifier bounds {{{body}}}")
        return lo, hi

    def atom(self) -> _Node:
        ch = self.peek()
        if ch is None:
            raise self.error("unexpected end of pattern")
        if ch == "(":
            self.next()
            node = self.alt()
            if self.peek() != ")":
                raise self.error("unbalanced parenthesis")
            self.next()
            return node
        if ch == "[":
            return _Node("chars", chars=self._char_class())
        if ch == ".":
            self.next()
            return _Node("chars", chars=_CharSet(frozenset("\n"), negated=True))
        if ch == "\\":
            self.next()
            esc = self.next() if self.peek() is not None else None
            if esc is None:
                raise self.error("dangling backslash")
            return _Node("chars", chars=_ESCAPES.get(esc, _CharSet(frozenset(esc))))
        if ch in ")|*+?":
            raise self.error(f"unexpected {ch!r}")
        self.next()
        return _Node("chars", chars=_CharSet(frozenset(ch)))

    def _char_class(self) -> _CharSet:
        self.next()  # consume '['
        negated = self.peek() == "^"
        if negated:
            self.next()
        chars: Set[str] = set()
        negated_parts: List[_CharSet] = []
        first = True
        while self.peek() != "]" or first:
            first = False
            ch = self.peek()
            if ch is None:
                raise self.error("unterminated character class")
            if ch == "\\":
                self.next()
                if self.peek() is None:
                    raise self.error("dangling backslash in character class")
                esc = self.next()
                part = _ESCAPES.get(esc, _CharSet(frozenset(esc)))
                if part.negated:
                    negated_parts.append(part)
                else:
                    chars |= part.chars
                continue
            self.next()
            if self.peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                self.next()  # consume '-'
                end = self.next()
                if ord(end) < ord(ch):
                    raise self.error(f"bad range {ch}-{end}")
                chars |= {chr(c) for c in range(ord(ch), ord(end) + 1)}
            else:
                chars.add(ch)
        self.next()  # consume ']'
        if negated_parts:
            # [\D...] style classes inside a positive class need the alphabet to
            # resolve; rare enough to refuse rather than approximate
            raise self.error("negated escape inside a character class is unsupported")
        return _CharSet(frozenset(chars), negated=negated)


def _ast_chars(node: _Node) -> Set[str]:
    if node.kind == "chars":
        return set(node.chars.chars)
    out: Set[str] = set()
    for child in node.children:
        out |= _ast_chars(child)
    return out


# ---------------------------------------------------------------------------
# Thompson NFA -> subset-construction DFA over an explicit (projected) alphabet.


class _NFA:
    def __init__(self) -> None:
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[FrozenSet[str], int]]] = []

    def state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1


def _build_nfa(node: _Node, nfa: _NFA, alphabet: FrozenSet[str]) -> Tuple[int, int]:
    """Returns (entry, exit) state ids for ``node``'s fragment."""
    if node.kind == "chars":
        s, e = nfa.state(), nfa.state()
        nfa.edges[s].append((node.chars.resolve(alphabet), e))
        return s, e
    if node.kind == "concat":
        s = e = nfa.state()
        for child in node.children:
            cs, ce = _build_nfa(child, nfa, alphabet)
            nfa.eps[e].add(cs)
            e = ce
        return s, e
    if node.kind == "alt":
        s, e = nfa.state(), nfa.state()
        for child in node.children:
            cs, ce = _build_nfa(child, nfa, alphabet)
            nfa.eps[s].add(cs)
            nfa.eps[ce].add(e)
        return s, e
    if node.kind == "repeat":
        (child,) = node.children
        s = e = nfa.state()
        for _ in range(node.lo):  # mandatory copies
            cs, ce = _build_nfa(child, nfa, alphabet)
            nfa.eps[e].add(cs)
            e = ce
        if node.hi is None:  # Kleene tail
            cs, ce = _build_nfa(child, nfa, alphabet)
            nfa.eps[e].add(cs)
            nfa.eps[ce].add(cs)
            out = nfa.state()
            nfa.eps[e].add(out)
            nfa.eps[ce].add(out)
            return s, out
        tail_exits = [e]
        for _ in range(node.hi - node.lo):  # optional copies
            cs, ce = _build_nfa(child, nfa, alphabet)
            nfa.eps[e].add(cs)
            e = ce
            tail_exits.append(e)
        out = nfa.state()
        for t in tail_exits:
            nfa.eps[t].add(out)
        return s, out
    raise AssertionError(node.kind)


def _eps_closure(nfa: _NFA, states: FrozenSet[int]) -> FrozenSet[int]:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _char_dfa(
    pattern: str, alphabet: FrozenSet[str]
) -> Tuple[List[Dict[str, int]], List[bool]]:
    """Subset-construction DFA: returns (transitions, accepting) with state 0 the
    start state; missing dict entries are dead."""
    ast = _Parser(pattern).parse()
    alphabet = frozenset(alphabet | _ast_chars(ast))
    nfa = _NFA()
    entry, exit_ = _build_nfa(ast, nfa, alphabet)
    start = _eps_closure(nfa, frozenset([entry]))
    index: Dict[FrozenSet[int], int] = {start: 0}
    trans: List[Dict[str, int]] = [{}]
    accepting: List[bool] = [exit_ in start]
    work = [start]
    while work:
        stateset = work.pop()
        si = index[stateset]
        by_char: Dict[str, Set[int]] = {}
        for s in stateset:
            for charset, target in nfa.edges[s]:
                for ch in charset:
                    by_char.setdefault(ch, set()).add(target)
        for ch, targets in by_char.items():
            nxt = _eps_closure(nfa, frozenset(targets))
            if nxt not in index:
                index[nxt] = len(trans)
                trans.append({})
                accepting.append(exit_ in nxt)
                work.append(nxt)
            trans[si][ch] = index[nxt]
    # char-level liveness: drop states that cannot reach an accepting state
    n = len(trans)
    live = [accepting[i] for i in range(n)]
    changed = True
    while changed:
        changed = False
        for i in range(n):
            if not live[i] and any(live[t] for t in trans[i].values()):
                live[i] = True
                changed = True
    if not live[0]:
        raise ValueError(f"regex {pattern!r} matches no string")
    for i in range(n):
        trans[i] = {ch: t for ch, t in trans[i].items() if live[t]}
    return trans, accepting


# ---------------------------------------------------------------------------
# Token projection.


@dataclasses.dataclass(frozen=True)
class TokenConstraint:
    """One grammar projected onto a token vocabulary.

    ``trans[s, t]``: state after emitting token id ``t`` from state ``s``
    (meaningful only where ``allowed[s, t]``). ``allowed[s, t]``: whether token
    ``t`` keeps the output inside the language from state ``s`` (for the EOS
    column: whether the output so far is a complete sentence of it). State 0 is
    the start state. Build with :func:`compile_regex` / :func:`literal_choice`.
    """

    trans: np.ndarray  # [S, V] int32
    allowed: np.ndarray  # [S, V] bool
    eos_id: int

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])

    @property
    def vocab_size(self) -> int:
        return int(self.trans.shape[1])


def compile_regex(pattern: str, vocab: Sequence[str], eos_id: int) -> TokenConstraint:
    """Compile ``pattern`` (fullmatch semantics, like ``re.fullmatch``) into a
    :class:`TokenConstraint` over ``vocab`` — ``vocab[t]`` is the decoded text
    of token id ``t``. Empty-string tokens (pads, non-text specials) are never
    allowed; ``eos_id`` is allowed exactly at accepting states. Raises if the
    language is empty or no vocabulary tokenization can realize it."""
    if not 0 <= eos_id < len(vocab):
        raise ValueError(f"eos_id {eos_id} outside vocab of {len(vocab)}")
    alphabet = frozenset(ch for tok in vocab for ch in tok)
    ctrans, caccept = _char_dfa(pattern, alphabet)
    n_char_states = len(ctrans)

    # vectorized projection: fold each token's chars over ALL states at once
    # (numpy gathers, -1 = dead) — O(V * len * S) array steps instead of a
    # pure-Python walk per (state, token) pair, which matters at real-tokenizer
    # vocab sizes (32k-128k) at server startup
    chars = sorted({ch for row in ctrans for ch in row})
    char_ix = {ch: i for i, ch in enumerate(chars)}
    cmat = np.full((n_char_states, len(chars) + 1), -1, np.int64)  # last col = unknown char
    for s, row in enumerate(ctrans):
        for ch, t in row.items():
            cmat[s, char_ix[ch]] = t

    V = len(vocab)
    trans = np.zeros((n_char_states, V), np.int32)
    allowed = np.zeros((n_char_states, V), bool)
    all_states = np.arange(n_char_states)
    for t, text in enumerate(vocab):
        if t == eos_id or text == "":
            continue
        cur = all_states
        for ch in text:
            ci = char_ix.get(ch, len(chars))
            cur = np.where(cur >= 0, cmat[np.maximum(cur, 0), ci], -1)
            if not (cur >= 0).any():
                break
        ok = cur >= 0
        trans[ok, t] = cur[ok]
        allowed[:, t] = ok
    # token-level liveness: a char-live state can still be a dead end for THIS
    # vocab (no token realizes an escaping path). Backwards fixed point; then
    # transitions into token-dead states are disallowed, so every reachable
    # state keeps >= 1 allowed token and the masked logits row is never all -inf.
    live = np.asarray(caccept, bool).copy()
    while True:
        reach_live = (allowed & live[trans]).any(axis=1)
        new_live = live | reach_live
        if (new_live == live).all():
            break
        live = new_live
    if not live[0]:
        raise ValueError(
            f"regex {pattern!r} is unreachable with this vocabulary "
            "(no token sequence spells a sentence of it)"
        )
    allowed &= live[trans]
    for s in np.flatnonzero(np.asarray(caccept, bool)):
        trans[s, eos_id] = s  # terminal self-loop; the row is done after EOS
        allowed[s, eos_id] = True
    keep = np.flatnonzero(live)
    remap = np.full(n_char_states, -1, np.int64)
    remap[keep] = np.arange(len(keep))
    trans = remap[trans[keep]].astype(np.int32)
    trans[trans < 0] = 0  # disallowed entries; value never read
    return TokenConstraint(trans=trans, allowed=allowed[keep], eos_id=eos_id)


def literal_choice(choices: Sequence[str], vocab: Sequence[str], eos_id: int) -> TokenConstraint:
    """Constrain output to exactly one of ``choices`` (an enum — classifier
    labels, tool names). Sugar over :func:`compile_regex` with escaping."""
    if not choices:
        raise ValueError("choices must be non-empty")
    return compile_regex("|".join(_escape(s) for s in choices), vocab, eos_id)


_ESCAPE_META = "\\.[](){}|*+?^$-"


def _escape(text: str) -> str:
    return "".join("\\" + c if c in _ESCAPE_META else c for c in text)


#: regex fragments for flat JSON values (no nesting — nested JSON is not
#: regular; bound the shape instead of the grammar)
JSON_VALUE_PATTERNS = {
    # control chars excluded: JSON forbids raw \n/\t/\r inside strings, and a
    # grammar that allows them forces output json.loads rejects
    "string": r'"[^"\\\n\t\r]*"',
    "number": r"-?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?",
    "integer": r"-?(0|[1-9][0-9]*)",
    "boolean": r"(true|false)",
    "null": r"null",
}


def json_object(
    fields: Dict[str, str], vocab: Sequence[str], eos_id: int, *, whitespace: bool = True
) -> TokenConstraint:
    """A grammar for a FLAT JSON object with exactly these keys, in order.

    ``fields`` maps key -> value pattern: a name from
    :data:`JSON_VALUE_PATTERNS` (``"string"``, ``"number"``, ``"integer"``,
    ``"boolean"``, ``"null"``) or a raw regex for the value (e.g. an enum
    ``'("red"|"green")'``). Keys are emitted in dict order — fixed key order is
    what makes the object a REGULAR language (arbitrary key order is factorial
    in alternations; nesting is not regular at all — for those, generate into a
    string field and parse downstream).

    >>> g = json_object({"name": "string", "age": "integer"}, vocab, eos_id)
    >>> # accepts {"name": "ada", "age": 36} modulo whitespace

    ``whitespace=True`` permits up to 4 blanks/newlines where JSON allows them
    — BOUNDED on purpose: an unbounded ``[ \\t\\n]*`` lets a
    whitespace-leaning model burn the whole token budget on blanks without
    ever reaching the accept state (observed with an untrained model).
    """
    if not fields:
        raise ValueError("fields must be non-empty")
    ws = r"[ \t\n]{0,4}" if whitespace else ""
    parts = []
    for key, value in fields.items():
        if any(c in key for c in '"\\') or any(ord(c) < 0x20 for c in key):
            # such keys would need JSON string escaping inside the emitted
            # text; refusing beats silently forcing invalid JSON
            raise ValueError(f"key {key!r} contains characters needing JSON escaping")
        if value not in JSON_VALUE_PATTERNS and value.isidentifier():
            # identifier-shaped non-names are almost certainly typos ('bool'
            # for 'boolean'); a raw-regex value always contains metachars/quotes
            raise ValueError(
                f"unknown value type {value!r}; expected one of {sorted(JSON_VALUE_PATTERNS)} "
                "or a raw regex"
            )
        value_pat = JSON_VALUE_PATTERNS.get(value, value)
        # plain (...) groups: this dialect has no captures, so grouping is free
        parts.append(f'"{_escape(key)}"{ws}:{ws}({value_pat})')
    body = (f"{ws},{ws}").join(parts)
    return compile_regex(f"\\{{{ws}{body}{ws}\\}}", vocab, eos_id)


def stop_sequences(stops: Sequence[str], vocab: Sequence[str], eos_id: int) -> TokenConstraint:
    """A constraint enforcing STOP STRINGS: generation is free until any of
    ``stops`` completes in the emitted text, after which only EOS is allowed —
    the stream ends with the stop string, one token later (the OpenAI-style
    ``stop=`` knob, expressed as a grammar so every engine and composition —
    batcher, speculative, beam, paged, preemption-resume — inherits it with
    zero new machinery).

    Built directly as an Aho-Corasick automaton over the stop strings (the
    "text not containing X" language needs complement/lookahead the regex
    dialect deliberately lacks). Token rule: a token whose text completes a
    stop AT ITS END transitions to the must-EOS state; a token that would run
    PAST a completion mid-text is disallowed (the model takes a shorter
    tokenization of the same text — single-char tokens keep this live); EOS is
    allowed everywhere (free generation may end at will)."""
    if not stops or any(not s for s in stops):
        raise ValueError("stops must be non-empty strings")
    if not 0 <= eos_id < len(vocab):
        raise ValueError(f"eos_id {eos_id} outside vocab of {len(vocab)}")
    # Aho-Corasick: trie states over stop prefixes + failure links -> a total
    # transition function (a DFA) with match flags
    trie: List[Dict[str, int]] = [{}]
    match: List[bool] = [False]
    for stop in stops:
        s = 0
        for ch in stop:
            if ch not in trie[s]:
                trie.append({})
                match.append(False)
                trie[s][ch] = len(trie) - 1
            s = trie[s][ch]
        match[s] = True
    fail = [0] * len(trie)
    dq = collections.deque(trie[0].values())
    while dq:
        s = dq.popleft()
        for ch, t in trie[s].items():
            dq.append(t)
            f = fail[s]
            while f and ch not in trie[f]:
                f = fail[f]
            fail[t] = trie[f][ch] if ch in trie[f] and trie[f][ch] != t else 0
            match[t] = match[t] or match[fail[t]]

    def step(s: int, ch: str) -> int:
        while s and ch not in trie[s]:
            s = fail[s]
        return trie[s].get(ch, 0)

    # totalize into a dense char table so the token projection is the same
    # vectorized numpy fold compile_regex uses — a pure-Python per-(state,
    # token, char) walk is seconds of host startup at real vocab sizes
    chars = sorted({ch for s in stops for ch in s})
    char_ix = {ch: i for i, ch in enumerate(chars)}
    S = len(trie)
    cmat = np.zeros((S, len(chars) + 1), np.int64)  # last col: any other char -> root
    for s in range(S):
        for ci, ch in enumerate(chars):
            cmat[s, ci] = step(s, ch)
    match_arr = np.asarray(match, bool)

    n_states = S + 1  # + the terminal must-EOS state
    must_eos = S
    V = len(vocab)
    trans = np.zeros((n_states, V), np.int32)
    allowed = np.zeros((n_states, V), bool)
    all_states = np.arange(S)
    for t, text in enumerate(vocab):
        if t == eos_id or text == "":
            continue
        cur = all_states
        early = np.zeros((S,), bool)  # a stop completed STRICTLY inside the token
        for i, ch in enumerate(text):
            cur = cmat[cur, char_ix.get(ch, len(chars))]
            if i < len(text) - 1:
                early |= match_arr[cur]
        ok = ~early
        trans[:S][ok, t] = np.where(match_arr[cur[ok]], must_eos, cur[ok])
        allowed[:S][ok, t] = True
    allowed[:, eos_id] = True  # free generation may end at will; forced at must_eos
    trans[:, eos_id] = np.arange(n_states)  # terminal self-loops
    # match trie states are unreachable as targets (completing tokens map to
    # must_eos) but collapse their rows too; must-EOS allows ONLY eos
    for s in np.flatnonzero(match_arr):
        allowed[s, :] = False
        allowed[s, eos_id] = True
    allowed[must_eos, :] = False
    allowed[must_eos, eos_id] = True
    return TokenConstraint(trans=trans, allowed=allowed, eos_id=eos_id)


def vocab_from_tokenizer(tokenizer: Any) -> List[str]:
    """Best-effort ``token id -> decoded text`` list for a Hugging Face
    tokenizer, for :func:`compile_regex`. Decodes each id in isolation
    (``convert_ids_to_tokens`` + ``convert_tokens_to_string``) so BPE space
    markers (``Ġ``/``Ċ``) and sentencepiece ``▁`` become real characters;
    special tokens (bos/eos/pad/unk/additional) map to ``""`` so the compiler
    never allows them mid-output. Caveat: tokenizers whose detokenization is
    context-dependent beyond leading-space markers (rare) can drift — spot-check
    ``"".join(vocab[t] for t in tokenizer.encode(s, add_special_tokens=False))
    == s`` on your data before trusting a grammar with it."""
    size = int(tokenizer.vocab_size)
    extra = getattr(tokenizer, "added_tokens_encoder", {}) or {}
    size = max([size] + [i + 1 for i in extra.values()])
    special = set(getattr(tokenizer, "all_special_ids", []) or [])
    out: List[str] = []
    for i in range(size):
        if i in special:
            out.append("")
            continue
        try:
            token = tokenizer.convert_ids_to_tokens(i)
            if token is None:
                out.append("")
                continue
            text = tokenizer.convert_tokens_to_string([token])
            # sentencepiece detok strips a word-initial ▁'s space when the
            # token is FIRST in the sequence (transformers
            # LlamaTokenizer.convert_tokens_to_string) — but per-id extraction
            # makes every token first, which would drop every inter-word
            # space; re-prepend it (the same correction outlines/guidance make)
            if token.startswith("▁") and not text.startswith(" "):
                text = " " + text
        except Exception:
            out.append("")
            continue
        out.append(text)
    return out


class ConstraintSet:
    """A union of grammars in ONE table pair, renumbered so that a grammar is
    nothing but a start state: ``starts[g]`` for grammar id ``g``. Grammar id 0
    is always FREE (every token allowed, nothing enforced) so unconstrained and
    constrained rows batch together; user grammars get ids 1..n in the order
    given. One compiled decode program serves every member."""

    def __init__(self, constraints: Sequence[TokenConstraint]):
        if not constraints:
            raise ValueError("ConstraintSet needs at least one TokenConstraint")
        V = constraints[0].vocab_size
        eos = constraints[0].eos_id
        for c in constraints:
            if c.vocab_size != V or c.eos_id != eos:
                raise ValueError("all constraints must share one vocab and eos_id")
        # FREE grammar: one state, all tokens allowed, self-loop
        blocks_t = [np.zeros((1, V), np.int32)]
        blocks_a = [np.ones((1, V), bool)]
        starts = [0]
        offset = 1
        for c in constraints:
            blocks_t.append(c.trans + offset)
            blocks_a.append(c.allowed)
            starts.append(offset)
            offset += c.n_states
        self.trans = np.concatenate(blocks_t, axis=0)
        self.allowed = np.concatenate(blocks_a, axis=0)
        self.starts = np.asarray(starts, np.int32)
        self.eos_id = eos
        self._device_tables: Dict[Any, Tuple[Any, Any]] = {}

    def device_tables(self, device: Any) -> Tuple[Any, Any]:
        """Memoized device copies ``(trans, allowed)`` — int32 and bool
        tensors on ``device`` — shared by every engine built over this set on
        that device: a real-tokenizer set is tens of MB ([S, 128k] int32 +
        bool). Index ``trans`` with the state cast to ``long``."""
        device = torch.device(device)
        tables = self._device_tables.get(device)
        if tables is None:
            tables = (
                torch.as_tensor(self.trans, dtype=torch.int32).to(device),
                torch.as_tensor(self.allowed, dtype=torch.bool).to(device),
            )
            self._device_tables[device] = tables
        return tables

    @property
    def n_grammars(self) -> int:
        """Including the implicit FREE grammar at id 0."""
        return len(self.starts)

    @property
    def vocab_size(self) -> int:
        return int(self.trans.shape[1])

    def start_states(self, grammar_ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(grammar_ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_grammars):
            raise ValueError(
                f"grammar id out of range [0, {self.n_grammars}) in {list(grammar_ids)}"
            )
        return self.starts[ids].astype(np.int32)
