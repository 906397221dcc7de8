"""{{app_name}}: a character-level language model, trained and served with PyTorch.

The port's copy of the JAX package's ``text-generation`` template: a tiny
Llama-architecture decoder trained by the step trainer, serving
*autoregressive text generation* through the Dataset/Model protocol —
``model.predict(features=[...])`` takes prompt strings and returns
continuations from the KV-cached generation engine
(``unionml_tpu_torch.models.Generator``).

The corpus, vocabulary, model shape, dataset, trainer schedule, grammars and
engine arguments are the JAX template's. What differs is torch's:

- the trainer is one AdamW step (``make_train_step``) over the port's
  ``TrainState``, with optax.adamw's defaults written out;
- ``init`` builds the module on the ``device`` hyperparameter: unset means
  the card, and the CPU is asked for with ``{"device": "cpu"}``;
- ``speculative_generator``'s draft is a module carrying its own weights
  (seeded, on the state's device) rather than a params tree;
- the corpus is a list of lines with the default splitter's rows written
  out (``splitter``) rather than a DataFrame: the app imports no pandas;
- to shard, add ``MeshSpec(...)``/``llama_partition_rules()`` to the
  TrainerConfig (one process a rank, see the comment at ``trainer``).

Structured output: prefix a prompt with ``@<grammar> `` (see ``GRAMMARS``) and
that request's continuation is constrained to the grammar's regex by
token-DFA masking — per request, through ``predictor`` and the
continuously-batched ``stream_predictor``.
"""

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from unionml_tpu_torch import Dataset, Model, TrainerConfig, TrainState, make_train_step
from unionml_tpu_torch.models import (
    ConstraintSet,
    DraftSpec,
    GenerationConfig,
    Generator,
    Llama,
    LlamaConfig,
    causal_lm_loss,
    compile_regex,
)
from unionml_tpu_torch.serving import ContinuousBatcher

SEQ_LEN = 32
NEW_TOKENS = 48

# a self-contained training corpus: classic pangrams and proverbs; replace with
# a reader that loads your own text files
CORPUS = [
    "the quick brown fox jumps over the lazy dog.",
    "pack my box with five dozen liquor jugs.",
    "how vexingly quick daft zebras jump!",
    "a stitch in time saves nine.",
    "all that glitters is not gold.",
    "actions speak louder than words.",
    "practice makes perfect, and perfect needs practice.",
    "the early bird catches the worm.",
]

#: char-level vocabulary; id 0 is reserved as pad
CHARS = sorted({c for line in CORPUS for c in line})
PAD_ID = 0
STOI = {c: i + 1 for i, c in enumerate(CHARS)}
ITOS = {i + 1: c for i, c in enumerate(CHARS)}
VOCAB_SIZE = len(CHARS) + 1

config = LlamaConfig.tiny(
    vocab_size=VOCAB_SIZE, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, hidden_dim=128,
    max_seq_len=SEQ_LEN + NEW_TOKENS, dtype=torch.float32, param_dtype=torch.float32,
)

dataset = Dataset(name="char_corpus", test_size=0.2, shuffle=True)
model = Model(name="{{app_name}}", dataset=dataset)
model.__app_module__ = "app:model"


def encode(text: str) -> List[int]:
    return [STOI[c] for c in text if c in STOI]


def decode(token_ids) -> str:
    return "".join(ITOS.get(int(t), "") for t in token_ids if int(t) != PAD_ID)


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


@dataset.reader
def reader(repeats: int = 24) -> List[str]:
    return CORPUS * repeats


@dataset.splitter
def splitter(data: List[str], test_size: float, shuffle: bool, random_state: int) -> Tuple[List[str], List[str]]:
    """The default splitter's rows over a list of lines: a seeded
    permutation, the test rows from its tail (the app imports no pandas, so
    it runs where pandas is not installed)."""
    n_test = int(np.ceil(len(data) * test_size))
    order = np.random.default_rng(random_state).permutation(len(data)) if shuffle else np.arange(len(data))
    return [data[i] for i in order[:-n_test]], [data[i] for i in order[-n_test:]]


@dataset.parser
def parser(
    data: List[str], features: Optional[List[str]], targets: List[str]
) -> Tuple[np.ndarray, np.ndarray]:
    """Chop the corpus into fixed [N, SEQ_LEN] next-token-prediction windows."""
    stream: List[int] = []
    for line in data:
        stream.extend(encode(line) + [STOI[" "]])
    n = max(len(stream) // SEQ_LEN, 1)
    stream = (stream * SEQ_LEN)[: n * SEQ_LEN]  # wrap-pad the tail window
    windows = np.asarray(stream, np.int32).reshape(n, SEQ_LEN)
    return windows, windows  # causal LM: the tokens are their own labels


@model.init
def init(hyperparameters: dict) -> TrainState:
    """The module on ``hyperparameters["device"]`` (unset: the card), seeded
    weights, AdamW with optax.adamw's defaults."""
    module = Llama(config, device=hyperparameters.get("device"), seed=0)
    optimizer = torch.optim.AdamW(
        module.parameters(), lr=hyperparameters.get("learning_rate", 3e-3), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4,
    )
    return TrainState(module, optimizer)


def _loss(module: Llama, batch) -> torch.Tensor:
    tokens = batch[0] if isinstance(batch, (tuple, list)) else batch
    return causal_lm_loss(module, tokens)


_step = make_train_step(_loss)


# to shard, add ``mesh=MeshSpec(...)`` and ``partition_rules=llama_partition_rules()`` (from
# ``unionml_tpu_torch.parallel`` and ``.models``) to the TrainerConfig and run one process a rank
# (``torchrun --nproc-per-node N``); every rank trains the same app on its shards and rows
@model.trainer(config=TrainerConfig(epochs=6, batch_size=16, shuffle=True))
def trainer(state: TrainState, batch) -> tuple:
    return _step(state, batch)


@model.evaluator
def evaluator(state: TrainState, features: np.ndarray, target: np.ndarray) -> float:
    """Mean next-token cross-entropy (nats); lower is better."""
    with torch.no_grad():
        return float(causal_lm_loss(state.model, torch.as_tensor(features, device=_device(state))))


@dataset.feature_loader
def feature_loader(raw) -> List[str]:
    """Serving features are prompt strings (or one string)."""
    if isinstance(raw, str):
        return [raw]
    return [str(p) for p in raw]


#: canned output grammars (structured decoding): a prompt of the form
#: "@<name> <prompt text>" constrains THAT request's continuation to the named
#: grammar — the regex compiles to token-DFA tables
#: (unionml_tpu_torch.models.structured) and rides the shared decode loop.
#: Plain prompts decode freely.
GRAMMARS = {"word": r"[a-z]+", "sentence": r"[a-z][a-z ]*[.!]"}


def _constraint_set():
    texts = [""] * VOCAB_SIZE
    for i, c in ITOS.items():
        texts[i] = c
    # PAD doubles as EOS for constrained rows: decode() already strips it, and
    # the model never emits it unprompted (no PAD in the training windows)
    return ConstraintSet([compile_regex(p, texts, eos_id=PAD_ID) for p in GRAMMARS.values()])


_CONSTRAINTS = _constraint_set()


def _split_grammar(feature: str) -> Tuple[int, str]:
    """'@word the quick' -> (grammar id of 'word', 'the quick'); plain prompts
    ride the FREE grammar (id 0)."""
    if feature.startswith("@"):
        name, _, rest = feature[1:].partition(" ")
        if name in GRAMMARS:
            return list(GRAMMARS).index(name) + 1, rest
    return 0, feature


_generators: dict = {}


def _generator_for(state: TrainState) -> Generator:
    # Keyed on id(state) but storing (state, gen): the strong ref keeps the
    # TrainState alive so a freed state's id can never alias a new one.
    entry = _generators.get(id(state))
    gen = entry[1] if entry is not None and entry[0] is state else None
    if gen is None:
        gen = Generator(
            state.model,
            GenerationConfig(
                max_new_tokens=NEW_TOKENS, temperature=0.0, prompt_buckets=(SEQ_LEN,),
                eos_id=PAD_ID, constraints=_CONSTRAINTS,
            ),
            device=_device(state),
        )
        _generators.clear()  # one live state at a time; drop stale engines
        _generators[id(state)] = (state, gen)
    return gen


def _encode_prompts(features: List[str]) -> List[List[int]]:
    return [encode(p) or [STOI[" "]] for p in features]


@model.predictor
def predictor(state: TrainState, features: List[str]) -> List[str]:
    gids, prompts = zip(*(_split_grammar(f) for f in features))
    out = _generator_for(state)(_encode_prompts(list(prompts)), constraint=list(gids))
    return [p + decode(row) for p, row in zip(prompts, out)]


_continuous: dict = {}
_continuous_lock = threading.Lock()


def _continuous_for(state: TrainState) -> ContinuousBatcher:
    """A shared ContinuousBatcher: concurrent streams join the same
    fixed-slot decode loop (one dispatch advances every resident stream)
    instead of queueing behind each other. The lock makes concurrent first
    requests create ONE engine; a batcher for a replaced state drains its
    in-flight streams in the background before stopping."""
    with _continuous_lock:
        # (state, batcher) pairs: holding the state reference pins its id, so a
        # replaced-and-collected TrainState can never alias a cache hit.
        entry = _continuous.get(id(state))
        batcher = entry[1] if entry is not None and entry[0] is state else None
        if batcher is None:
            for _, stale in _continuous.values():
                stale.close(wait=False)  # graceful: residents finish, no new joins
            _continuous.clear()
            # paged KV: a shared block pool with lazy allocation, sized below
            # slots x worst-case so memory tracks tokens decoded; max_waiting
            # bounds the slot-wait queue (the 33rd waiting stream is shed with
            # QueueFullError instead of queueing without bound)
            batcher = ContinuousBatcher(
                _generator_for(state), slots=4, decode_chunk=8, block_size=16, pool_blocks=16,
                max_waiting=32,
            )
            _continuous[id(state)] = (state, batcher)
            model.generation_batcher = batcher  # the serving half reports its utilization
        return batcher


def _generation_warmup() -> None:
    """Startup hook (for the serving half, after the artifact loads): build
    the shared batcher and run its warm-up requests so the first real stream
    pays no cold start."""
    _continuous_for(model.artifact.model_object).warmup()


model.generation_warmup = _generation_warmup


@model.stream_predictor
def stream_predictor(state: TrainState, features: List[str]):
    """Yields per-prompt text pieces as they decode — concatenating a
    prompt's pieces reproduces the ``predictor`` continuation. Single-prompt
    requests (the typical streaming call) ride the shared continuous-batching
    loop; multi-prompt requests stream as one batch."""
    gids, texts = zip(*(_split_grammar(f) for f in features))
    prompts = _encode_prompts(list(texts))
    if len(prompts) == 1:
        for chunk in _continuous_for(state).submit(prompts[0], constraint=gids[0]):
            yield [decode(chunk)]
        return
    for chunk in _generator_for(state).stream(prompts, chunk_size=8, constraint=list(gids)):
        yield [decode(row) for row in chunk]


# --- speculative decoding: a half-depth draft proposes, the full model verifies.
# Greedy output is token-for-token identical to plain decoding (the draft can
# only change speed, never tokens); the template test pins that oracle.
draft_config = dataclasses.replace(config, n_layers=1)


def speculative_generator(state: TrainState, draft_module: Optional[Llama] = None, gamma: int = 4) -> Generator:
    """The Generator façade with a DraftSpec attached. Pass a trained
    ``draft_module`` (e.g. a distilled copy) for real speedups; an untrained
    draft (seeded, on the state's device) still produces exact greedy
    tokens, just with low acceptance."""
    if draft_module is None:
        draft_module = Llama(draft_config, device=_device(state), seed=1)
    cfg = GenerationConfig(
        max_new_tokens=NEW_TOKENS, temperature=0.0, prompt_buckets=(SEQ_LEN,),
        # the SAME eos and grammar set as the predictor's config, so the
        # greedy-exact oracle (spec output == predict output) holds for plain
        # and grammar-constrained calls alike
        eos_id=PAD_ID,
        constraints=_CONSTRAINTS,
        draft=DraftSpec(module=draft_module, gamma=gamma),
    )
    return Generator(state.model, cfg, device=_device(state))


if __name__ == "__main__":
    model_object, metrics = model.train(hyperparameters={"learning_rate": 3e-3})
    print("eval loss:", metrics)
    print(model.predict(features=["the quick brown "])[0])
    model.save("model_object.ckpt")
