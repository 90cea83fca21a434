"""Embedding providers (the port's own copy of
``qrag_tpu.pipeline.embeddings``; same classes and outputs).

Three providers behind one callable interface
(``embed(texts) -> (N, dim) float32``):

* `MockEmbedder` — bit-exact reproduction of the reference's
  deterministic mock (``src/reranker/quantum.py:169-185``): seed the
  NumPy MT19937 generator with ``sum(ord(c) for c in text)``, draw
  ``dim`` uniforms, L2-normalize.  Required for fidelity-parity tests.

* `HashEmbedder` — a stronger deterministic local embedder for building
  real-size corpora without network access: per-text blake2b-seeded
  Gaussian vectors, unit-norm.  Stable across processes/platforms
  (unlike Python ``hash``; SURVEY.md Appendix A.5).

* `OpenAIEmbedder` — the reference's production path
  (``mcp/server/tools/fetch_embeddings.py``): OpenAI embeddings with
  the API key from AWS SSM ``/openai/api_key`` (env fallback), chunking
  long texts and averaging chunk embeddings.  Gated on the optional
  ``openai``/``boto3`` packages; raises a clear error when absent.

* "trained" — the bi-encoder (``models/bi_encoder.TrainedEmbedder``)
  on ``device`` (CUDA unless the caller asks for the CPU).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from qrag_tpu_torch.config import EmbeddingConfig
from qrag_tpu_torch.pipeline.chunker import chunk_text

Embedder = Callable[[Sequence[str]], np.ndarray]


class MockEmbedder:
    """Reference-parity deterministic mock embedding."""

    def __init__(self, dim: int = 8):
        # reference default: n_qubits * 2 = 8 (``quantum.py:184``)
        self.dim = int(dim)

    def embed_one(self, text: str) -> np.ndarray:
        seed = sum(ord(c) for c in text)
        # RandomState(seed).random_sample == np.random.seed + np.random.random
        rng = np.random.RandomState(seed % (2 ** 32))
        v = rng.random_sample(self.dim)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.embed_one(t) for t in texts])


class HashEmbedder:
    """Deterministic content-hash Gaussian embedding (unit-norm)."""

    def __init__(self, dim: int = 1536):
        self.dim = int(dim)

    def embed_one(self, text: str) -> np.ndarray:
        digest = hashlib.blake2b(text.encode("utf-8"), digest_size=8).digest()
        seed = int.from_bytes(digest, "little") % (2 ** 32)
        rng = np.random.RandomState(seed)
        v = rng.standard_normal(self.dim)
        n = np.linalg.norm(v)
        return (v / (n if n > 0 else 1.0)).astype(np.float32)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        if not texts:
            return np.zeros((0, self.dim), dtype=np.float32)
        return np.stack([self.embed_one(t) for t in texts])


class OpenAIEmbedder:
    """OpenAI embeddings with SSM key lookup + chunk-and-average.

    Mirrors ``fetch_embeddings.py:115-165``: key from SSM parameter
    (``WithDecryption=True``) with ``OPENAI_API_KEY`` env fallback, one
    API call per chunk; per-chunk failures are skipped (the reference's
    skip-on-error contract, ``fetch_embeddings.py:153-155``).
    """

    def __init__(self, config: Optional[EmbeddingConfig] = None):
        self.config = config or EmbeddingConfig(provider="openai")
        self.dim = self.config.dim
        self._client = None

    def _get_api_key(self) -> str:
        key = os.environ.get("OPENAI_API_KEY")
        if key:
            return key
        try:
            import boto3  # type: ignore

            ssm = boto3.client("ssm")
            resp = ssm.get_parameter(
                Name=self.config.ssm_api_key_param, WithDecryption=True
            )
            return resp["Parameter"]["Value"]
        except Exception as e:
            raise RuntimeError(
                "OpenAI API key unavailable: set OPENAI_API_KEY or configure "
                f"SSM parameter {self.config.ssm_api_key_param}"
            ) from e

    def _client_or_raise(self):
        if self._client is None:
            try:
                from openai import OpenAI  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "openai package not installed; use provider='mock' or "
                    "'hash' for local embeddings"
                ) from e
            self._client = OpenAI(api_key=self._get_api_key())
        return self._client

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        client = self._client_or_raise()
        out: List[np.ndarray] = []
        for text in texts:
            chunks = chunk_text(text, self.config.max_tokens_per_chunk)
            vecs: List[np.ndarray] = []
            for chunk in chunks:
                try:
                    resp = client.embeddings.create(
                        model=self.config.model, input=chunk
                    )
                    vecs.append(
                        np.asarray(resp.data[0].embedding, dtype=np.float32)
                    )
                except Exception:
                    continue  # skip-on-error per chunk
            if vecs:
                mean = np.mean(vecs, axis=0)
                n = np.linalg.norm(mean)
                out.append((mean / (n if n > 0 else 1.0)).astype(np.float32))
            else:
                out.append(np.zeros(self.dim, dtype=np.float32))
        return np.stack(out) if out else np.zeros((0, self.dim), np.float32)


def get_embedder(config: Optional[EmbeddingConfig] = None, device=None) -> Embedder:
    """The configured provider; ``device`` is where the trained
    bi-encoder runs (the other providers run on the host)."""
    config = config or EmbeddingConfig()
    if config.provider == "mock":
        return MockEmbedder(dim=config.dim if config.dim else 8)
    if config.provider == "hash":
        return HashEmbedder(dim=config.dim)
    if config.provider == "openai":
        return OpenAIEmbedder(config)
    if config.provider == "trained":
        # config.model is the weights dir (random init when absent, as
        # in the reference); without saved weights the projection width
        # follows config.dim, so the index and the embedder agree
        from qrag_tpu_torch.models.bi_encoder import BiEncoderConfig, TrainedEmbedder

        weights = config.model if os.path.isdir(config.model) else None
        return TrainedEmbedder(
            cfg=BiEncoderConfig(out_dim=config.dim), weights_dir=weights, device=device
        )
    raise ValueError(f"unknown embedding provider {config.provider!r}")
