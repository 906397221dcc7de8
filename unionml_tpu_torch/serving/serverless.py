"""Serverless serving adapters, counterpart of ``unionml_tpu/serving/serverless.py``
(host code: it runs on the port's :class:`~unionml_tpu_torch.serving.app.ServingApp`
as the JAX module runs on the JAX package's).

Parity surface: the reference ships two AWS Lambda deployment styles —

- an API-Gateway HTTP app wrapped with ``Mangum(app)``
  (templates/basic-aws-lambda/{{cookiecutter.app_name}}/app.py), and
- an S3-event batch handler that downloads a features file, runs
  ``dataset.get_features`` -> ``model.predict``, and uploads predictions
  (templates/basic-aws-lambda-s3/{{cookiecutter.app_name}}/app.py; tested in
  tests/unit/test_aws_lambda_handler.py:75-161).

Mangum and boto3 are not dependencies of the package, so this module implements the two adapters
directly against the port's :class:`~unionml_tpu_torch.serving.app.ServingApp`: a tiny
API-Gateway-event <-> HTTP bridge (the Mangum analog, supporting both RESTv1 and
HTTP-API-v2 event shapes) and an object-store batch handler with an injectable client
so cloud SDKs plug in without being imports of the framework.
"""

from __future__ import annotations

import asyncio
import base64
import json
import tempfile
import urllib.parse
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Protocol

from unionml_tpu_torch._logging import logger
from unionml_tpu_torch.serving.app import ServingApp, _to_jsonable


def _event_request(event: Dict[str, Any]) -> tuple:
    """Extract (method, path, body, headers) from an API Gateway event (v1 or v2
    payload). Headers are lower-cased so deadline propagation
    (``X-Request-Deadline-Ms``) works identically to the socket server."""
    if "requestContext" in event and "http" in event.get("requestContext", {}):  # HTTP API v2
        method = event["requestContext"]["http"]["method"]
        path = event.get("rawPath") or event["requestContext"]["http"].get("path", "/")
    else:  # REST API v1
        method = event.get("httpMethod", "GET")
        path = event.get("path", "/")
    body = event.get("body") or ""
    if event.get("isBase64Encoded"):
        raw = base64.b64decode(body)
    else:
        raw = body.encode() if isinstance(body, str) else body
    headers = {
        str(name).lower(): str(value)
        for name, value in (event.get("headers") or {}).items()
        if value is not None
    }
    return method, path, raw, headers


def lambda_handler(
    serving: ServingApp, *, preload: bool = False
) -> Callable[[Dict[str, Any], Any], Dict[str, Any]]:
    """Wrap a :class:`ServingApp` as an API-Gateway Lambda handler (the Mangum analog).

    Usage in an app module::

        model.serve()               # returns the ServingApp
        handler = lambda_handler(model.serve())

    **Scale-to-zero**: the handler closure retains ``serving`` for the
    lifetime of the execution environment, so the engine built and warmed on
    the first invocation is REUSED by every later one: ``startup()`` is
    idempotent and runs exactly once per container, never per request. With
    the AOT program store armed (``UNIONML_TPU_AOT_PRELOAD`` pointed at a
    baked layer or mounted volume), that one startup installs the kernel
    libraries its programs launch from the store (no ``nvcc``) and captures
    the programs as CUDA graphs, so a scaled-from-zero container answers its
    first token without building a kernel (:mod:`unionml_tpu_torch.serving.aot`). ``preload=True`` moves the startup to
    handler CREATION time — the serverless platform's init phase, which most
    providers bill (and time-box) separately from request handling — so even
    the first invocation sees a warm engine.

    ``handler.stats`` reports ``invocations``, ``startups`` (1 after the first
    use, by contract), and ``cold_start_s`` (wall time of the one real
    startup) for the cold-start telemetry the bench lane and tests pin.
    """
    stats: Dict[str, Any] = {"invocations": 0, "startups": 0, "cold_start_s": None}

    def _startup_once() -> None:
        if getattr(serving, "_started", False):
            return
        import time

        begin = time.perf_counter()
        serving.startup()
        stats["startups"] += 1
        stats["cold_start_s"] = round(time.perf_counter() - begin, 3)
        logger.info(f"serverless cold start: engine ready in {stats['cold_start_s']} s")

    if preload:
        _startup_once()

    def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, Any]:
        stats["invocations"] += 1
        method, path, body, headers = _event_request(event)

        async def run() -> Any:
            # dispatch_with_headers: the request-id echo (and Retry-After on
            # shed responses) must survive the event bridge — API Gateway
            # forwards response headers, so callers correlate exactly like
            # socket clients
            _startup_once()
            return await serving.server.dispatch_with_headers(method, path, body, headers)

        status, payload, content_type, extra = asyncio.run(run())
        body_out = payload if isinstance(payload, str) else json.dumps(payload, default=str)
        return {
            "statusCode": status,
            "headers": {"Content-Type": content_type, **extra},
            "body": body_out,
            "isBase64Encoded": False,
        }

    handler.stats = stats
    return handler


class ObjectStoreClient(Protocol):
    """Minimal get/put protocol for the batch handler. boto3's S3 client satisfies it
    via the adapter below; tests inject an in-memory implementation."""

    def download_file(self, bucket: str, key: str, filename: str) -> None: ...

    def upload_file(self, filename: str, bucket: str, key: str) -> None: ...


def make_batch_handler(
    model: Any,
    client: ObjectStoreClient,
    *,
    output_bucket: Optional[str] = None,
    output_prefix: str = "predictions/",
    model_path_env: Optional[str] = None,
) -> Callable[[Dict[str, Any], Any], Dict[str, Any]]:
    """Build an S3-event batch-prediction handler.

    Parity: templates/basic-aws-lambda-s3 ``lambda_handler`` — for each S3 record:
    download the features file, run it through ``dataset.get_features`` ->
    ``model.predict``, and upload the predictions JSON next to the input (or to
    ``output_bucket``/``output_prefix``).
    """

    def handler(event: Dict[str, Any], context: Any = None) -> Dict[str, Any]:
        if model.artifact is None:
            model.load_from_env(**({"env_var": model_path_env} if model_path_env else {}))
        outputs = []
        for record in event.get("Records", []):
            s3_info = record.get("s3", {})
            bucket = s3_info.get("bucket", {}).get("name")
            key = s3_info.get("object", {}).get("key")
            # S3 event notifications URL-encode object keys (spaces arrive as '+')
            key = urllib.parse.unquote_plus(key) if key else key
            if not bucket or not key:
                logger.warning(f"skipping malformed S3 record: {record}")
                continue
            if output_bucket in (None, bucket) and key.startswith(output_prefix):
                # our own output landing back as an event — processing it would loop
                # forever when the bucket notification covers the whole bucket
                logger.info(f"skipping own output object s3://{bucket}/{key}")
                continue
            with tempfile.TemporaryDirectory() as tmp:
                local_in = str(Path(tmp) / Path(key).name)
                client.download_file(bucket, key, local_in)
                # run the feature pipeline exactly once, then go straight to the
                # predict-from-features graph (model.predict(features=...) would
                # re-apply dataset.get_features — the double-processing quirk
                # SURVEY.md §3.2 flags in the reference)
                features = model._dataset.get_features(Path(local_in))
                predictions = model.predict_from_features_workflow()(
                    model_object=model.artifact.model_object, features=features
                )
                # keep the input key's directory prefix: same-named files under
                # different prefixes must not overwrite each other's predictions
                out_key = f"{output_prefix}{Path(key).with_suffix('.json')}"
                local_out = str(Path(tmp) / "predictions.json")
                Path(local_out).write_text(json.dumps(_to_jsonable(predictions), default=str))
                client.upload_file(local_out, output_bucket or bucket, out_key)
                outputs.append({"bucket": output_bucket or bucket, "key": out_key})
        return {"statusCode": 200, "outputs": outputs}

    return handler
