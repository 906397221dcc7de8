"""OpenAI-compatible completions surface over the generation serving stack,
the port's copy of ``unionml_tpu/serving/openai_api.py``.

``POST /v1/completions`` and ``POST /v1/chat/completions`` map the OpenAI wire
schema — ``stream=true`` server-sent events terminated by ``data: [DONE]``,
``usage`` token accounting, ``finish_reason`` semantics — onto the existing
continuous-batching engine (``model.generation_batcher``), the same
compatibility move vLLM and SGLang made to become drop-in servers: any client
built on the OpenAI SDK can point its ``base_url`` here and drive the stack,
its ``api_key`` doubling as the tenant identity (serving/tenancy.py). The
routes are registered on every :class:`~unionml_tpu_torch.serving.app.ServingApp`;
without a generation engine they answer a clear 404, mirroring
``/predict-stream``'s no-stream-predictor contract.

Compatibility matrix (docs/serving.md "Multi-tenant QoS" carries the table):

- supported: ``prompt`` (string with a tokenizer, or a token-id list),
  ``messages``, ``max_tokens`` (clipped to the engine's configured budget),
  ``stream``, ``model`` (echoed), ``stop`` (string or list — emission
  truncates at the earliest match with ``finish_reason: "stop"``, the same
  truncate-at-match semantics the grammar ``stop_sequences`` constraint
  enforces device-side; here the scan runs server-side at the emission
  boundary so ARBITRARY per-request stop strings work without a recompile),
  ``logprobs`` (completions int/bool; chat ``logprobs: true``) — the sampled
  token's log-probability from the decode scan rides every stream chunk and
  the final choice (``top_logprobs`` beyond the sampled token are not
  computed), per-request deadlines via the stack's ``X-Request-Deadline-Ms``,
  429 + ``Retry-After`` sheds, ``X-Tenant-Id`` / ``X-Priority`` QoS headers;
- accepted but inert: ``temperature``/``top_p``/seeds — the sampling policy is
  fixed server-side by the engine's :class:`GenerationConfig` (every resident
  stream shares one decode dispatch);
- rejected with 400: ``n``/``best_of`` > 1, ``echo``, ``suffix``, string
  prompts without a ``model.tokenizer``, and ``logprobs`` on engines that
  cannot surface it (speculative decoding, the multi-host coordinator).

Tokenizer contract: ``model.tokenizer`` with ``encode(str) -> list[int]`` and
``decode(list[int]) -> str`` (``apply_chat_template(messages) -> str``
honored when present). Without one, prompts must be token-id lists and
completion ``text`` falls back to space-joined token ids — enough for tests
and id-level clients, stated in the matrix.

Traffic capture: with ``serve --record-traffic DIR`` armed, every parsed
``/v1`` request taps the process-wide
:class:`~unionml_tpu_torch.workloads.traces.TraceRecorder` (token ids, budget,
tenant, priority, stream flag) — the capture side of the record→replay→verdict
loop (docs/workloads.md).
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from unionml_tpu_torch.observability.trace import current_request_id
from unionml_tpu_torch.serving.http import HTTPError
from unionml_tpu_torch.serving.overload import DeadlineExceeded, QueueFullError, current_deadline

__all__ = ["register_openai_routes"]

#: OpenAI's documented default when max_tokens is omitted
_DEFAULT_MAX_TOKENS = 16

#: request knobs we cannot honor silently — a client that sets them gets a
#: clear 400 instead of subtly different completions
_UNSUPPORTED = ("n", "best_of", "echo", "suffix", "tools", "functions")

#: OpenAI caps stop at 4 sequences; matching that bound keeps the per-chunk
#: scan trivially cheap
_MAX_STOPS = 4


def _parse_stop(payload: "Dict[str, Any]") -> "List[str]":
    """The request's ``stop`` as a list of non-empty strings ([] = none)."""
    raw = payload.get("stop")
    if raw is None:
        return []
    stops = [raw] if isinstance(raw, str) else raw
    if (
        not isinstance(stops, list)
        or not stops
        or len(stops) > _MAX_STOPS
        or any(not isinstance(s, str) or not s for s in stops)
    ):
        raise HTTPError(
            400,
            f"stop must be a non-empty string or a list of 1-{_MAX_STOPS} "
            f"non-empty strings, got {raw!r}",
        )
    return list(stops)


def _parse_logprobs(payload: "Dict[str, Any]", *, chat: bool) -> bool:
    """Whether the request wants per-token logprobs. Chat uses ``logprobs:
    true``; classic completions accept an int (the top-N count — only the
    SAMPLED token's logprob is computed, so any positive count gets that one
    column, documented in the matrix)."""
    raw = payload.get("logprobs")
    if raw is None or raw is False:
        return False
    if raw is True:
        return True
    if chat or not isinstance(raw, int) or raw < 0:
        raise HTTPError(
            400,
            "logprobs must be true/false (chat) or a non-negative integer "
            f"(completions), got {raw!r}",
        )
    return raw > 0


class _StopScanner:
    """Incremental stop-sequence matcher over decoded emission text.

    The grammar machinery (models/structured.py ``stop_sequences``) enforces
    stops device-side but needs the stop strings compiled into the engine's
    ConstraintSet; a per-request ``stop=`` arrives too late for that, so the
    serving layer applies the SAME truncate-at-earliest-match semantics at the
    emission boundary. A rolling holdback of ``max(len(stop)) - 1`` characters
    catches matches spanning chunk boundaries; once matched, the consumer
    closes the engine stream — tokens past the stop are never generated."""

    def __init__(self, stops: "List[str]"):
        self.stops = stops
        self._buffer = ""
        self._hold = max(len(s) for s in stops) - 1
        self.matched = False

    def feed(self, text: str) -> str:
        """Scan ``text``; returns the emittable portion (truncated at the
        earliest stop match, which also flips :attr:`matched`)."""
        self._buffer += text
        best = -1
        for stop in self.stops:
            idx = self._buffer.find(stop)
            if idx >= 0 and (best < 0 or idx < best):
                best = idx
        if best >= 0:
            self.matched = True
            out, self._buffer = self._buffer[:best], ""
            return out
        if self._hold and len(self._buffer) > self._hold:
            out = self._buffer[: -self._hold]
            self._buffer = self._buffer[-self._hold :]
            return out
        if not self._hold:
            out, self._buffer = self._buffer, ""
            return out
        return ""

    def flush(self) -> str:
        """The held-back tail once the stream ended without a match."""
        out, self._buffer = self._buffer, ""
        return out


def register_openai_routes(app: Any) -> None:
    """Attach the ``/v1`` routes to a serving app's HTTP server."""
    server = app.server

    async def completions(body: bytes):
        return await _completions(app, body, chat=False)

    async def chat_completions(body: bytes):
        return await _completions(app, body, chat=True)

    async def models(body: bytes):
        name = _model_name(app, None)
        return 200, {
            "object": "list",
            "data": [{"id": name, "object": "model", "owned_by": "unionml-tpu"}],
        }, "application/json"

    server.route("POST", "/v1/completions", completions)
    server.route("POST", "/v1/chat/completions", chat_completions)
    server.route("GET", "/v1/models", models)


def _model_name(app: Any, requested: Optional[str]) -> str:
    if requested:
        return str(requested)
    return str(getattr(app.model, "name", None) or "unionml-tpu")


def _engine(app: Any) -> Any:
    engine = getattr(app.model, "generation_batcher", None)
    if engine is None or not hasattr(engine, "submit"):
        raise HTTPError(
            404,
            "no generation engine; the /v1 completions surface needs "
            "model.generation_batcher (a ContinuousBatcher or ReplicaSet)",
        )
    return engine


def _gen_config(engine: Any) -> Any:
    gen = getattr(engine, "gen", None)
    if gen is None:
        batchers = getattr(engine, "batchers", None)  # a ReplicaSet
        if batchers:
            gen = getattr(batchers[0], "gen", None)
    if gen is None:
        raise HTTPError(500, "generation engine exposes no Generator config")
    return gen.config


def _tokenizer(app: Any) -> Optional[Any]:
    return getattr(app.model, "tokenizer", None)


def _encode_prompt(app: Any, prompt: Any) -> "List[int]":
    """A request ``prompt`` to token ids: id lists pass through, strings need
    the model's tokenizer. Everything else (including OpenAI's
    list-of-strings batch form) is a documented 400."""
    if isinstance(prompt, str):
        tok = _tokenizer(app)
        if tok is None or not hasattr(tok, "encode"):
            raise HTTPError(
                400,
                "string prompts need a tokenizer (set model.tokenizer with "
                "encode/decode); pass a token-id list instead",
            )
        ids = [int(t) for t in tok.encode(prompt)]
    elif isinstance(prompt, (list, tuple)) and all(
        isinstance(t, int) and not isinstance(t, bool) for t in prompt
    ):
        ids = [int(t) for t in prompt]
    else:
        raise HTTPError(
            400,
            "prompt must be a string or a list of token ids (prompt batches "
            "are not supported; send one request per prompt)",
        )
    if not ids:
        raise HTTPError(400, "prompt must be non-empty")
    return ids


def _decode_tokens(app: Any, ids: "List[int]") -> str:
    tok = _tokenizer(app)
    if tok is not None and hasattr(tok, "decode"):
        return str(tok.decode(list(ids)))
    # the documented no-tokenizer fallback: space-joined token ids — exact,
    # reversible, and honest about what the server actually produced
    return " ".join(str(i) for i in ids)


def _chunk_glue(app: Any) -> str:
    """What joins consecutive chunks' decoded text: nothing for a real
    tokenizer (decode pieces concatenate), the fallback's space for id-text —
    so incremental stop scanning sees the same string the one-shot decode
    would have produced."""
    tok = _tokenizer(app)
    return "" if (tok is not None and hasattr(tok, "decode")) else " "


def _chat_to_prompt(app: Any, messages: Any) -> Any:
    """OpenAI ``messages`` to a single prompt: the tokenizer's own
    ``apply_chat_template`` when it has one, else a plain role-prefixed
    transcript ending with the assistant cue (documented in the matrix)."""
    if not isinstance(messages, list) or not messages:
        raise HTTPError(400, "messages must be a non-empty list of {role, content} objects")
    for message in messages:
        if (
            not isinstance(message, dict)
            or not isinstance(message.get("role"), str)
            or not isinstance(message.get("content"), str)
        ):
            raise HTTPError(400, "each message needs string 'role' and 'content' fields")
    tok = _tokenizer(app)
    if tok is not None and hasattr(tok, "apply_chat_template"):
        return tok.apply_chat_template(messages)
    return "\n".join(f"{m['role']}: {m['content']}" for m in messages) + "\nassistant:"


def _parse_request(
    app: Any, body: bytes, *, chat: bool
) -> "Tuple[Dict[str, Any], List[int], int, bool, str, List[str], bool]":
    payload = app._parse_json_object(body)
    for knob in _UNSUPPORTED:
        value = payload.get(knob)
        allowed = (None, 1) if knob in ("n", "best_of") else (None,)
        if value not in allowed:
            raise HTTPError(
                400,
                f"unsupported parameter {knob!r} (see the compatibility matrix "
                "in docs/serving.md)",
            )
    # explicit-knob validation first: a malformed stop/logprobs is reported as
    # ITS error even when the prompt would also fail (no tokenizer)
    stops = _parse_stop(payload)
    want_logprobs = _parse_logprobs(payload, chat=chat)
    if chat:
        prompt = _chat_to_prompt(app, payload.get("messages"))
    else:
        prompt = payload.get("prompt")
        if prompt is None:
            raise HTTPError(400, "prompt must be supplied")
    ids = _encode_prompt(app, prompt)
    cfg = _gen_config(_engine(app))
    raw_max = payload.get("max_tokens", _DEFAULT_MAX_TOKENS)
    if not isinstance(raw_max, int) or isinstance(raw_max, bool) or raw_max < 1:
        raise HTTPError(400, f"max_tokens must be a positive integer, got {raw_max!r}")
    # clip to the budget the engine's cache is sized for (OpenAI clients
    # routinely send large max_tokens; a hard reject would break drop-in use)
    max_new = min(raw_max, int(cfg.max_new_tokens))
    stream = bool(payload.get("stream", False))
    return payload, ids, max_new, stream, _model_name(app, payload.get("model")), stops, want_logprobs


def _record_traffic(route: str, ids: "List[int]", max_new: int, stream: bool) -> None:
    """Tap the process-wide traffic recorder (``serve --record-traffic``) with
    the PARSED request — None = capture off, zero cost."""
    from unionml_tpu_torch.workloads.traces import active_traffic_recorder

    recorder = active_traffic_recorder()
    if recorder is None:
        return
    from unionml_tpu_torch.serving.tenancy import current_priority, current_tenant, priority_name

    priority = current_priority()
    recorder.record(
        route,
        prompt=ids,
        max_tokens=max_new,
        stream=stream,
        tenant=current_tenant(),
        priority=priority_name(priority) if priority is not None else None,
    )


async def _completions(app: Any, body: bytes, *, chat: bool):
    payload, ids, max_new, stream, model_name, stops, want_logprobs = _parse_request(
        app, body, chat=chat
    )
    engine = _engine(app)
    cfg = _gen_config(engine)
    _record_traffic("/v1/chat/completions" if chat else "/v1/completions", ids, max_new, stream)
    rid = current_request_id() or "req"
    created = int(time.time())  # wall clock, display only — never subtracted
    completion_id = f"{'chatcmpl' if chat else 'cmpl'}-{rid}"
    submit_kwargs: "Dict[str, Any]" = dict(max_new_tokens=max_new, deadline=current_deadline())
    if want_logprobs:
        # only passed when requested, so engines predating the kwarg (the
        # multi-host coordinator) keep serving plain requests untouched
        submit_kwargs["logprobs"] = True
    try:
        token_stream = engine.submit(ids, **submit_kwargs)
    except (QueueFullError, DeadlineExceeded):
        raise  # the HTTP layer maps these to 429 (+ Retry-After) / 503
    except TypeError as exc:
        if want_logprobs:
            raise HTTPError(400, f"logprobs is not supported by this engine: {exc}")
        raise
    except ValueError as exc:
        raise HTTPError(400, f"generation rejected the request: {exc}")
    loop = asyncio.get_running_loop()
    iterator = iter(token_stream)
    sentinel = object()
    # run_in_executor does not propagate contextvars; the engine thread reads
    # nothing, but close/tracing paths do — same carry as /predict-stream
    ctx = contextvars.copy_context()

    def pull() -> Any:
        return next(iterator, sentinel)

    eos_id = cfg.eos_id
    scanner = _StopScanner(stops) if stops else None
    lp_consumed = 0

    def take_logprobs(count: int) -> "Optional[List[float]]":
        """The next ``count`` logprobs off the engine stream (appended before
        their tokens were enqueued, so they are always there by now)."""
        nonlocal lp_consumed
        if not want_logprobs:
            return None
        values = getattr(token_stream, "logprobs", [])[lp_consumed : lp_consumed + count]
        lp_consumed += count
        return [round(float(v), 6) for v in values]

    glue = _chunk_glue(app)

    if not stream:
        emitted: "List[int]" = []
        pieces: "List[str]" = []
        fed_any = False
        stopped = False
        try:
            while True:
                chunk = await loop.run_in_executor(None, ctx.run, pull)
                if chunk is sentinel:
                    break
                chunk_ids = [int(t) for t in np.asarray(chunk).ravel()]
                emitted.extend(chunk_ids)
                if scanner is not None and chunk_ids:
                    prefix = glue if fed_any else ""
                    fed_any = True
                    pieces.append(scanner.feed(prefix + _decode_tokens(app, chunk_ids)))
                    if scanner.matched:
                        # truncate-at-match: nothing past the stop is pulled —
                        # closing below frees the engine slot promptly
                        stopped = True
                        break
        except (QueueFullError, DeadlineExceeded):
            raise
        except Exception as exc:
            raise HTTPError(500, f"generation failed: {type(exc).__name__}: {exc}")
        finally:
            token_stream.close()
        logprobs = take_logprobs(len(emitted))
        text: Optional[str] = None
        if scanner is not None:
            if not stopped:
                pieces.append(scanner.flush())
            text = "".join(pieces)
        return 200, _final_payload(
            app, chat, completion_id, created, model_name, emitted, max_new, len(ids), eos_id,
            text=text, stopped=stopped, logprobs=logprobs,
        ), "application/json"

    # ---- stream=true: server-sent events, one data: line per engine chunk,
    # a final chunk carrying finish_reason + usage, then data: [DONE]
    try:
        first = await loop.run_in_executor(None, ctx.run, pull)
    except (QueueFullError, DeadlineExceeded):
        raise
    except Exception as exc:
        token_stream.close()
        raise HTTPError(500, f"generation failed: {type(exc).__name__}: {exc}")

    object_name = "chat.completion.chunk" if chat else "text_completion"

    def sse(obj: "Dict[str, Any]") -> bytes:
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    def chunk_payload(
        piece: "List[int]", finish: Optional[str], *,
        text: Optional[str] = None, lps: "Optional[List[float]]" = None,
    ) -> "Dict[str, Any]":
        if text is None:
            text = _decode_tokens(app, piece) if piece else ""
        logprobs_block = _logprobs_block(app, chat, piece, lps) if lps is not None else None
        if chat:
            delta: "Dict[str, Any]" = {}
            if text:
                delta["content"] = text
            choice: "Dict[str, Any]" = {"index": 0, "delta": delta, "finish_reason": finish}
            if logprobs_block is not None:
                choice["logprobs"] = logprobs_block
        else:
            choice = {"index": 0, "text": text, "logprobs": logprobs_block, "finish_reason": finish}
        return {
            "id": completion_id, "object": object_name, "created": created,
            "model": model_name, "choices": [choice],
        }

    async def events():
        emitted = 0
        last_token: Optional[int] = None
        stopped = False
        fed_any = False
        try:
            if chat:
                # the OpenAI stream opener: role first, content deltas after
                yield sse({
                    "id": completion_id, "object": object_name, "created": created,
                    "model": model_name,
                    "choices": [{"index": 0, "delta": {"role": "assistant"}, "finish_reason": None}],
                })
            chunk = first
            while chunk is not sentinel:
                piece = [int(t) for t in np.asarray(chunk).ravel()]
                if piece:
                    emitted += len(piece)
                    last_token = piece[-1]
                    lps = take_logprobs(len(piece))
                    if scanner is not None:
                        prefix = glue if fed_any else ""
                        fed_any = True
                        text = scanner.feed(prefix + _decode_tokens(app, piece))
                        if scanner.matched:
                            stopped = True
                            if text or lps:
                                yield sse(chunk_payload(piece, None, text=text, lps=lps))
                            break
                        if text or lps:
                            # an all-held-back chunk still ships its logprobs
                            # (empty text) so the per-token columns stay whole
                            yield sse(chunk_payload(piece, None, text=text, lps=lps))
                    else:
                        yield sse(chunk_payload(piece, None, lps=lps))
                chunk = await loop.run_in_executor(None, ctx.run, pull)
            if scanner is not None and not stopped:
                tail = scanner.flush()
                if tail:
                    yield sse(chunk_payload([], None, text=tail))
            if stopped:
                finish = "stop"
            else:
                finish = "stop" if (eos_id is not None and last_token == eos_id) else "length"
            final = chunk_payload([], finish, text="")
            final["usage"] = _usage(len(ids), emitted)
            yield sse(final)
            yield b"data: [DONE]\n\n"
        finally:
            # the server acloses this generator on client disconnect; closing
            # the token stream releases the engine slot promptly (plain-object
            # close — safe from any thread, no generator re-entrancy hazard);
            # a stop match lands here too, freeing the slot mid-budget
            token_stream.close()

    return 200, events(), "text/event-stream"


def _logprobs_block(
    app: Any, chat: bool, piece: "List[int]", lps: "List[float]"
) -> "Dict[str, Any]":
    """The OpenAI logprobs shape for one run of tokens: chat uses the
    ``content`` entry list, classic completions the parallel-array form.
    Only the SAMPLED token's logprob is computed (top_logprobs stays null —
    the decode scan does not rank the rest of the vocabulary)."""
    tokens = [_decode_tokens(app, [tok]) for tok in piece]
    pairs = list(zip(tokens, lps))
    if chat:
        return {"content": [{"token": tok, "logprob": lp} for tok, lp in pairs]}
    return {
        "tokens": [tok for tok, _ in pairs],
        "token_logprobs": [lp for _, lp in pairs],
        "top_logprobs": None,
        "text_offset": None,
    }


def _usage(prompt_tokens: int, completion_tokens: int) -> "Dict[str, int]":
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _final_payload(
    app: Any,
    chat: bool,
    completion_id: str,
    created: int,
    model_name: str,
    emitted: "List[int]",
    max_new: int,
    prompt_tokens: int,
    eos_id: Optional[int],
    *,
    text: Optional[str] = None,
    stopped: bool = False,
    logprobs: "Optional[List[float]]" = None,
) -> "Dict[str, Any]":
    if text is None:
        text = _decode_tokens(app, emitted) if emitted else ""
    if stopped:
        finish = "stop"  # a matched stop= sequence, truncated at the match
    else:
        finish = "stop" if (eos_id is not None and emitted and emitted[-1] == eos_id) else "length"
    logprobs_block = (
        _logprobs_block(app, chat, emitted, logprobs) if logprobs is not None else None
    )
    if chat:
        choice: "Dict[str, Any]" = {
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }
        if logprobs_block is not None:
            choice["logprobs"] = logprobs_block
        object_name = "chat.completion"
    else:
        choice = {"index": 0, "text": text, "logprobs": logprobs_block, "finish_reason": finish}
        object_name = "text_completion"
    return {
        "id": completion_id,
        "object": object_name,
        "created": created,
        "model": model_name,
        "choices": [choice],
        "usage": _usage(prompt_tokens, len(emitted)),
    }
