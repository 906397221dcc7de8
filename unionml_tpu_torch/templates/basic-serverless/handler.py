"""Serverless entry points for {{app_name}}.

``handler`` answers API-Gateway HTTP events (the Mangum analog); ``make_batch`` builds
an object-store event handler given a client with ``download_file``/``upload_file``
(e.g. a boto3 S3 client).
"""

from unionml_tpu_torch.serving.serverless import lambda_handler, make_batch_handler

from app import model

serving = model.serve()
handler = lambda_handler(serving)


def make_batch(client, **kwargs):
    return make_batch_handler(model, client, **kwargs)
