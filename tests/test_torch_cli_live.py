"""The port's CLI-booted live server: ``tests/integration/test_cli_live.py``'s
two cases against ``python -m unionml_tpu_torch.cli serve``, run as a real
subprocess and polled over real HTTP, on the CPU.

- ``--workers 2`` over the sklearn app (the JAX file's ``:66``): the port is
  shared through ``SO_REUSEPORT`` and requests succeed;
- the port's ``text-generation`` template (``:92``), rendered by the port's
  ``init``, trained in a subprocess on the CPU and served: a ``@word``
  stream over ``/predict-stream`` matches the grammar's regex, and
  ``/metrics`` reports the generation engine.
"""

import contextlib
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import time
import urllib.request

from tests.test_torch_cli import CliRunner, cli_project  # noqa: F401  (the fixture)
from unionml_tpu_torch.cli import app

_REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[1])


@contextlib.contextmanager
def _served(args, cwd, env, log_path, startup_s):
    """Boot the port's ``serve`` as a subprocess, poll ``/health`` to a
    wall-clock deadline, yield the base URL, and tear down. Logs go to a
    file: an unread pipe fills during a chatty warmup and blocks the server."""
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    with open(log_path, "wb") as server_log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "unionml_tpu_torch.cli", "serve", *args, "--port", str(port)],
            cwd=cwd, env=env, stdout=server_log, stderr=subprocess.STDOUT,
        )
        try:
            base = f"http://127.0.0.1:{port}"
            deadline = time.monotonic() + startup_s
            while True:
                if proc.poll() is not None:
                    raise AssertionError(f"server exited rc={proc.returncode}: "
                                         + pathlib.Path(log_path).read_bytes()[-1500:].decode(errors="replace"))
                try:
                    with urllib.request.urlopen(base + "/health", timeout=1):
                        break
                except Exception:
                    if time.monotonic() > deadline:
                        tail = pathlib.Path(log_path).read_bytes()[-1500:]
                        raise AssertionError(f"server did not come up in {startup_s}s; log tail: "
                                             + tail.decode(errors="replace"))
                    time.sleep(0.2)
            yield base
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=60)


def test_serve_workers_flag_boots_multiprocess_server(cli_project, tmp_path):  # noqa: F811
    """--workers 2: two processes share the port and requests succeed."""
    import cli_app

    cli_app.model.train(hyperparameters={"max_iter": 500})
    model_file = cli_project / "model.joblib"
    cli_app.model.save(str(model_file))
    env = {k: v for k, v in os.environ.items() if k != "UNIONML_MODEL_PATH"}
    serve_args = ["cli_app:model", "--model-path", str(model_file), "--workers", "2", "--log-level", "info"]
    with _served(serve_args, cli_project, env, tmp_path / "server.log", 60) as base:
        for _ in range(4):  # the kernel may spread them over the workers
            with _post(base + "/predict", {"features": [{"x0": 1.0, "x1": 2.0}]}) as resp:
                assert resp.status == 200
                assert len(json.loads(resp.read())) == 1


def test_serve_text_generation_template_with_grammar(tmp_path, monkeypatch):
    """The generation stack through the port's CLI: ``init`` renders the
    template, a subprocess trains and saves it on the CPU, ``serve`` boots
    it, and a grammar-prefixed stream satisfies its regex."""
    monkeypatch.chdir(tmp_path)
    result = CliRunner().invoke(app, ["init", "genapp", "--template", "text-generation"])
    assert result.exit_code == 0, result.output
    project = tmp_path / "genapp"
    env = {k: v for k, v in os.environ.items() if k != "UNIONML_MODEL_PATH"}
    env["PYTHONPATH"] = _REPO_ROOT
    train = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.set_num_threads(2); import app;"
         "app.model.train(hyperparameters={'learning_rate': 3e-3, 'device': 'cpu'});"
         "app.model.save('model_object.ckpt')"],
        cwd=project, env=env, capture_output=True, text=True, timeout=600,
    )
    assert train.returncode == 0, train.stderr[-2000:]
    serve_args = ["app:model", "--model-path", str(project / "model_object.ckpt")]
    with _served(serve_args, project, env, tmp_path / "server.log", 300) as base:
        with _post(base + "/predict-stream", {"features": ["@word the quick brown "]}) as resp:
            assert resp.status == 200
            pieces = [json.loads(line)[0] for line in resp.read().decode().strip().splitlines()]
        text = "".join(pieces)
        assert text and re.fullmatch(r"[a-z]+", text), text
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            assert "generation" in json.loads(resp.read())
