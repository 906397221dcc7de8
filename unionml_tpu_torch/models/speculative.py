"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``unionml_tpu/models/speculative.py``. Draft-and-verify with
distribution-level rejection sampling (Leviathan et al.): each round the
draft decodes ``gamma`` tokens from the decoding policy's distribution q,
the target scores all ``gamma + 1`` positions in ONE cached forward, draft
token x is accepted with probability ``min(1, p(x)/q(x))``, and the first
rejection is replaced by a sample from ``norm(max(p - q, 0))`` (the bonus
token from p when everything accepts). Every round emits 1..gamma+1 tokens
and the output law is exactly the target's. Greedy decoding is the one-hot
case: acceptance is argmax prefix matching and the tokens equal the
target-only greedy run, the oracle the tests pin.

Both models follow the shared cache contract, so rollback is free: a row's
``lengths`` advances by its emitted count, and K/V written past it stays
invisible (``slot <= position``) until overwritten.

Where JAX rolls the rounds in one device-side ``lax.while_loop``, the port
runs a host loop of eager rounds; its condition reads one ``[B]`` bool from
the card a round. That sync is a host floor per round (a CUDA graph over the
round is later performance work). The loop state keeps the JAX layout,
``(t_cache, d_cache, tok, lengths, done, produced, out_buf, rounds,
accepted, key[, dfa_state])``, so :class:`ContinuousBatcher` shares it;
``rounds`` is a host int, ``accepted`` a device pair (accepted proposals,
and the proposals that had room in their row's budget) and ``key`` the
three ``torch.Generator`` streams (draft sampling, accept uniforms,
correction) derived from the call's seed, so one seed repeats its tokens.
Sampled runs draw other numbers than JAX's and match it in distribution.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from unionml_tpu_torch._device import DeviceLike
from unionml_tpu_torch.models.generate import GenerationConfig, Generator, filtered_logits, policy_probs

__all__ = ["SpeculativeGenerator", "rejection_step"]


def seeded_streams(seed: int, device: torch.device) -> Tuple[torch.Generator, ...]:
    """The round's three random streams (draft sampling, accept uniforms,
    correction draws), each seeded from ``seed`` and its index."""
    return tuple(torch.Generator(device=device).manual_seed(seed * 3 + i + 1) for i in range(3))


def rejection_step(
    p: torch.Tensor, q: torch.Tensor, drafts: torch.Tensor, u: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The round's rejection law. ``p [B, gamma + 1, V]`` and ``q [B, gamma,
    V]`` are the target's and the draft's policy distributions, ``drafts
    [B, gamma]`` the proposals and ``u [gamma, B]`` uniforms (None for
    greedy, where the one-hot law accepts exactly when ``p(x) > 0``).
    Returns each row's accepted count ``[B]`` int32 (draft i is accepted
    when ``u_i * q(x) < p(x)``, division-free, up to the first rejection)
    and the unnormalized distribution of the next token ``[B, V]``:
    ``max(p_a - q_a, 0)`` at the first rejected position a, ``p`` itself at
    the bonus position (q past gamma is 0), and ``p_a`` where the residual
    rounds to all zeros in f32."""
    batch, gamma = drafts.shape
    still = torch.ones((batch,), dtype=torch.bool, device=p.device)
    accepted = torch.zeros((batch,), dtype=torch.int32, device=p.device)
    for i in range(gamma):
        x = drafts[:, i: i + 1].long()
        px = p[:, i].gather(1, x)[:, 0]
        qx = q[:, i].gather(1, x)[:, 0]
        ok = px > 0 if u is None else u[i] * qx < px
        still = still & ok
        accepted = accepted + still.to(torch.int32)
    at = accepted.long()[:, None, None].expand(batch, 1, p.shape[-1])
    p_at = p.gather(1, at)[:, 0]
    q_at = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1).gather(1, at)[:, 0]
    resid = (p_at - q_at).clamp_min(0.0)
    return accepted, torch.where(resid.sum(-1, keepdim=True) > 0, resid, p_at)


class SpeculativeGenerator:
    """Speculative decoding over a (target, draft) model pair.

    >>> spec = SpeculativeGenerator(target, draft, GenerationConfig(max_new_tokens=128, temperature=0.0), gamma=4)
    >>> tokens = spec(prompts)          # == Generator(target, ...)(prompts)

    Both models carry their weights and live on ``device`` (``None`` = CUDA).
    ``quantize``/``quantize_draft`` ("int8") quantize either IN PLACE, as
    :class:`Generator`'s ``quantize`` does (None follows
    ``UNIONML_TPU_QUANTIZE``). ``rounds``/``accepted_tokens`` count the
    realized acceptance as the JAX package does (``accepted_tokens /
    (rounds * gamma)``, the accepts summed over a batch's rows);
    ``proposed_tokens`` counts the proposals each live row had budget room
    for, so ``accepted_tokens / proposed_tokens`` is the share of proposals
    accepted (1.0 for a perfect draft).
    """

    def __init__(
        self,
        target: Any,
        draft: Any,
        config: GenerationConfig = GenerationConfig(temperature=0.0),
        *,
        gamma: int = 4,
        device: DeviceLike = None,
        quantize: Optional[str] = None,
        quantize_draft: Optional[str] = None,
    ):
        # strip any attached DraftSpec: the internal Generators decode plainly
        config = dataclasses.replace(config, draft=None)
        target_gen = Generator(target, config, device=device, quantize=quantize)
        draft_gen = Generator(draft, target_gen.config, device=target_gen.device, quantize=quantize_draft)
        self._init_state(target_gen, draft_gen, target_gen.config, gamma)

    def _init_state(self, target: Generator, draft: Generator, config: GenerationConfig, gamma: int) -> None:
        """The construction body shared by ``__init__`` and :meth:`from_target`."""
        if gamma < 1:
            raise ValueError("gamma must be >= 1")
        if draft.model.config.vocab_size != target.model.config.vocab_size:
            raise ValueError("the draft and the target must share one vocabulary")
        self.config = config
        self.gamma = int(gamma)
        self.rounds = 0
        self.accepted_tokens = 0
        self.proposed_tokens = 0
        self._target = target
        self._draft = draft
        self.device = target.device

    @classmethod
    def from_target(cls, target: Generator, draft: Any) -> "SpeculativeGenerator":
        """Build around an EXISTING target :class:`Generator` (its model
        already quantized and placed) and a
        :class:`~unionml_tpu_torch.models.generate.DraftSpec`: the path behind
        ``GenerationConfig(draft=...)``."""
        self = cls.__new__(cls)
        # target.config already resolved the KV dtype: both caches share it
        config = dataclasses.replace(target.config, draft=None)
        draft_gen = Generator(draft.module, config, device=target.device, quantize=draft.quantize)
        self._init_state(target, draft_gen, config, draft.gamma)
        return self

    # ------------------------------------------------------------------ round

    @torch.no_grad()
    def _round(self, state: tuple, budget: torch.Tensor) -> tuple:
        """One draft-and-verify round over every row of ``state``; done rows
        emit nothing and never advance. ``budget`` ``[B]`` caps each row's
        ``produced``."""
        t_cache, d_cache, tok, lengths, done, produced, out_buf, rounds, acc_total, streams, *st = state
        draft_rng, accept_rng, corr_rng = streams
        cfg, gamma = self.config, self.gamma
        target, draft = self._target, self._draft
        greedy = cfg.temperature == 0.0
        pad, eos = cfg.pad_id, cfg.eos_id
        batch = tok.shape[0]
        dev = tok.device
        cs = st[0] if st else None

        # --- draft: gamma policy steps, each a [B, 1] cached forward; with
        # constraints the DFA walks the proposed path, and q is the masked law
        d_tok, d_len, s = tok, lengths, cs
        drafts, d_logits, states = [], [], []
        for _ in range(gamma):
            hidden, d_cache = draft.model(
                d_tok[:, None], positions=d_len[:, None], return_hidden=True, cache=d_cache
            )
            lg = draft._constrain(draft._head(hidden[:, 0]), s)
            if greedy:
                nxt = lg.argmax(dim=-1).to(torch.int32)
            else:
                probs = torch.softmax(filtered_logits(lg, cfg), dim=-1)
                nxt = torch.multinomial(probs, 1, generator=draft_rng)[:, 0].to(torch.int32)
            if s is not None:
                states.append(s)  # the state BEFORE this position
                s = target._cs_trans[s.long(), nxt.long()]
            drafts.append(nxt)
            d_logits.append(lg)
            d_tok, d_len = nxt, d_len + 1
        drafts_t = torch.stack(drafts, dim=1)  # [B, gamma]
        q = policy_probs(torch.stack(d_logits, dim=1), cfg)  # [B, gamma, V]

        # --- draft-cache completeness: the steps fed tok and drafts[:gamma-1],
        # so drafts[gamma-1]'s K/V slot is still unwritten; on an all-accept
        # round the next draft queries would attend to that stale (visible)
        # slot and acceptance would decay. One headless feed fills it; for rows
        # that rejected earlier the slot lies past their length (invisible).
        _, d_cache = draft.model(
            drafts_t[:, gamma - 1:], positions=(lengths + gamma)[:, None], return_hidden=True, cache=d_cache
        )

        # --- target: score tok and all gamma drafts in one cached forward
        inputs = torch.cat([tok[:, None], drafts_t], dim=1)  # [B, gamma + 1]
        positions = lengths[:, None] + torch.arange(gamma + 1, device=dev, dtype=lengths.dtype)[None]
        hidden, t_cache = target.model(
            inputs, positions=positions, return_hidden=True, cache=t_cache,
            token_mask=(~done)[:, None].expand(batch, gamma + 1),
        )
        logits = target._head(hidden)  # [B, gamma + 1, V] f32
        st_ext = None
        if cs is not None:
            # state before position i, i in [0, gamma] (the bonus position included)
            st_ext = torch.stack(states + [s], dim=1)
            logits = logits.masked_fill(~target._cs_allowed[st_ext.long()], -math.inf)
        p = policy_probs(logits, cfg)  # [B, gamma + 1, V]

        # --- rejection against the policy distributions (greedy: one-hot,
        # accept iff the argmaxes agree; no random draw is needed)
        u = None if greedy else torch.rand((gamma, batch), generator=accept_rng, device=dev)
        accepted, resid = rejection_step(p, q, drafts_t, u)
        if greedy:
            correction = resid.argmax(dim=-1).to(torch.int32)
        else:
            correction = torch.multinomial(resid, 1, generator=corr_rng)[:, 0].to(torch.int32)

        # --- emitted tokens this round: the accepted drafts, then the correction
        idx = torch.arange(gamma + 1, device=dev)[None]
        drafts_ext = torch.cat([drafts_t, torch.full((batch, 1), pad, dtype=torch.int32, device=dev)], dim=1)
        emit_mask = idx <= accepted[:, None]
        emitted = torch.where(idx < accepted[:, None], drafts_ext, correction[:, None])
        emitted = torch.where(emit_mask, emitted, pad)
        if eos is not None:
            is_eos = (emitted == eos) & emit_mask
            hits = is_eos.to(torch.int32)
            # truncate after the first eos: positions strictly beyond it emit pad
            emit_mask = emit_mask & ((hits.cumsum(dim=1) - hits) == 0)
            emitted = torch.where(emit_mask, emitted, pad)
            row_hits_eos = is_eos.any(dim=1)
        else:
            row_hits_eos = torch.zeros_like(done)
        emitted = torch.where(done[:, None], pad, emitted)
        n_emit = torch.where(done, 0, emit_mask.sum(dim=1)).to(torch.int32)
        # each row's own budget (continuous batching mixes caps in one batch)
        room = (budget - produced).clamp_min(0)
        n_emit = torch.minimum(n_emit, room)
        emitted = torch.where(idx < n_emit[:, None], emitted, pad)
        cols = produced.long().clamp(max=out_buf.shape[1] - (gamma + 1))[:, None] + idx
        out_buf.scatter_(1, cols, emitted)

        new_done = done | row_hits_eos | (produced + n_emit >= budget)
        j = (n_emit - 1).clamp_min(0).long()[:, None]
        last = emitted.gather(1, j)[:, 0]
        # the next round continues after the last emitted token; finished rows freeze
        tok = torch.where(new_done, tok, last)
        counted = torch.stack([torch.minimum(accepted, room), room.clamp(max=gamma)])
        acc_total = acc_total + torch.where(done, 0, counted).sum(dim=1)
        lengths = lengths + torch.where(done, 0, n_emit).to(lengths.dtype)
        produced = produced + n_emit
        if cs is not None:
            # past the LAST emitted token: emitted tokens are a prefix of the
            # proposed path, so the state before position j is st_ext[:, j]
            st_before = st_ext.gather(1, j)[:, 0]
            cs = torch.where(n_emit > 0, target._cs_trans[st_before.long(), last.long()], cs)
        return (t_cache, d_cache, tok, lengths, new_done, produced, out_buf, rounds + 1, acc_total, streams,
                *(() if cs is None else (cs,)))

    def _loop(self, state: tuple, floor: torch.Tensor, budget: torch.Tensor) -> tuple:
        """Roll rounds while any unfinished row has produced fewer than its
        ``floor`` ([B] int32; :meth:`__call__` passes the budget, streams and
        the engine ``produced + chunk``). The condition reads one ``[B]`` bool
        from the device a round."""
        while bool((~state[4] & (state[5] < floor)).any()):
            state = self._round(state, budget)
        return state

    # ------------------------------------------------------------------ generate

    def _start_state(self, prompts: Sequence[Sequence[int]], seed: int, constraint: Optional[Any] = None):
        """Prefill both models and assemble the loop state; the target's
        prompt-sampled token is emission #1 (the draft's is discarded). Both
        caches get ``gamma + 1`` rows of headroom for the last round's
        verify writes."""
        cfg = self.config
        n, tok0, _, t_carry = self._target._start(prompts, seed, extra_cache=self.gamma + 1, constraint=constraint)
        _, _, _, d_carry = self._draft._start(prompts, seed, extra_cache=self.gamma + 1, constraint=constraint)
        batch = int(tok0.shape[0])
        out_buf = torch.full((batch, cfg.max_new_tokens + self.gamma + 1), cfg.pad_id, dtype=torch.int32,
                             device=self.device)
        out_buf[:, 0] = tok0
        produced = torch.ones((batch,), dtype=torch.int32, device=self.device)
        done = t_carry[3] | (produced >= cfg.max_new_tokens)
        st = (t_carry[5],) if cfg.constraints is not None else ()
        accepted = torch.zeros((2,), dtype=torch.int64, device=self.device)
        return n, (t_carry[0], d_carry[0], tok0, t_carry[2], done, produced, out_buf, 0, accepted,
                   seeded_streams(seed, self.device), *st)

    def __call__(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, constraint: Optional[Any] = None
    ) -> np.ndarray:
        """Generate under the config's decoding policy: greedy output is
        exactly the target-only sequence, sampled output target-distributed.
        ``constraint`` masks both the draft's proposals and the target's
        verify by each row's DFA state."""
        cfg = self.config
        n, state = self._start_state(prompts, seed, constraint=constraint)
        budget = torch.full_like(state[5], cfg.max_new_tokens)
        state = self._loop(state, budget, budget)
        self._count(state[7], state[8])
        return state[6].cpu().numpy()[:n, : cfg.max_new_tokens]

    def stream(
        self, prompts: Sequence[Sequence[int]], *, seed: int = 0, chunk_size: int = 16,
        constraint: Optional[Any] = None,
    ) -> Iterator[List[np.ndarray]]:
        """Yield a LIST of ``len(prompts)`` 1-D int32 arrays of new tokens per
        row (the first yield is each row's prompt-sampled token). Rows advance
        by whole rounds, so chunks are ragged; each yield rolls rounds until
        every unfinished row has ``chunk_size`` more tokens. Token totals
        equal :meth:`__call__`'s."""
        cfg = self.config
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        n, state = self._start_state(prompts, seed, constraint=constraint)
        prev = np.ones((n,), np.int64)
        first = state[6][:n, :1].cpu().numpy()
        yield [first[i] for i in range(n)]
        budget = torch.full_like(state[5], cfg.max_new_tokens)
        try:
            while not bool(state[4][:n].all()):
                floor = torch.clamp(state[5] + chunk_size, max=cfg.max_new_tokens)
                state = self._loop(state, floor, budget)
                out_np = state[6].cpu().numpy()
                prod_np = state[5][:n].cpu().numpy()
                yield [out_np[i, prev[i]: prod_np[i]] for i in range(n)]
                prev = prod_np.astype(np.int64)
        finally:
            self._count(state[7], state[8])

    def _count(self, rounds: int, accepted: torch.Tensor, seen: Tuple[int, int, int] = (0, 0, 0)) -> Tuple[int, ...]:
        """Fold a loop state's counters into the totals, less what ``seen``
        already folded; returns the state's own ``(rounds, accepted,
        proposed)``."""
        now = (rounds, *accepted.tolist())
        self.rounds += now[0] - seen[0]
        self.accepted_tokens += now[1] - seen[1]
        self.proposed_tokens += now[2] - seen[2]
        return now
