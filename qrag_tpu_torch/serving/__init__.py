"""HTTP serving layer (stdlib)."""

from qrag_tpu_torch.serving.http_app import create_server, main, serve_in_thread
from qrag_tpu_torch.serving.http_app import main as serve_main

__all__ = ["create_server", "serve_in_thread", "serve_main", "main"]
