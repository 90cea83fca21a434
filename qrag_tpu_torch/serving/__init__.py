"""HTTP serving layer (stdlib)."""

from qrag_tpu_torch.serving.http_app import create_server, main

__all__ = ["create_server", "main"]
