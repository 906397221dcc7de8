from app import CHARS, NEW_TOKENS, decode, encode, model, speculative_generator, stream_predictor

#: the tests ask for the CPU; unset, the app trains and serves on the card
HYPERPARAMETERS = {"learning_rate": 3e-3, "device": "cpu"}


def test_train_and_generate():
    _, metrics = model.train(hyperparameters=HYPERPARAMETERS)
    assert metrics["train"] < 3.0  # mean next-token cross-entropy (nats)

    prompts = ["the quick brown ", "a stitch "]
    outputs = model.predict(features=prompts)
    assert len(outputs) == 2
    for prompt, text in zip(prompts, outputs):
        assert text.startswith(prompt)
        continuation = text[len(prompt):]
        assert 0 < len(continuation) <= NEW_TOKENS
        assert set(continuation) <= set(CHARS)

    # greedy decoding is deterministic
    assert model.predict(features=prompts) == outputs

    # single-prompt streaming rides the shared continuous-batching loop and
    # reassembles to the same continuation
    state = model.artifact.model_object
    pieces = [chunk[0] for chunk in stream_predictor(state, [prompts[0]])]
    assert prompts[0] + "".join(pieces) == outputs[0]

    # speculative decoding (half-depth draft through the Generator façade) is
    # greedy-EXACT: the draft can change speed, never tokens
    spec = speculative_generator(state)
    spec_out = spec([encode(p) for p in prompts])
    assert [p + decode(row) for p, row in zip(prompts, spec_out)] == outputs
