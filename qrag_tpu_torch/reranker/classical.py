"""Classical reranker (PyTorch port of ``qrag_tpu.reranker.classical``).

Two scorers:
* "cosine": embed query and documents (pluggable embedder) and score
  by cosine similarity, one matrix product on the device;
* "cross-encoder": the trained cross-encoder
  (``models/cross_encoder.CrossEncoderScorer``), batched forward on the
  device; ``long_doc_strategy="chunk_pool"`` scores fixed windows of
  each document and keeps the best.

The reference's behavioral contract is kept:
  * input validation failure -> original order, neutral 0.5 scores
  * scorer failure after retries -> original order, neutral scores;
    retries with 0.5 * (attempt + 1) s backoff
  * the scorer chain cross-encoder -> cosine -> neutral, sticky: once
    the cross-encoder fails out, later requests use cosine; a request
    whose scorer fell back midway is rescored whole on the fallback
    (one scale per request) with the cache cleared
  * text sanitation: whitespace collapse + truncation at
    ``max_sequence_length * 4`` chars
  * per-(query, doc) score cache keyed by a stable blake2 content hash
  * stable descending sort + top_k
"""

from __future__ import annotations

import hashlib
import logging
import re
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from qrag_tpu_torch.config import ClassicalConfig
from qrag_tpu_torch.device import resolve_device
from qrag_tpu_torch.documents import Document, validate_documents
from qrag_tpu_torch.ops.topk import cosine_scores
from qrag_tpu_torch.pipeline.embeddings import Embedder, HashEmbedder

logger = logging.getLogger(__name__)


def sanitize_text(text: str, max_sequence_length: int = 512) -> str:
    """Whitespace collapse + ~4-chars-per-token truncation."""
    if not isinstance(text, str):
        text = str(text)
    text = re.sub(r"\s+", " ", text).strip()
    limit = max_sequence_length * 4
    if len(text) > limit:
        text = text[:limit]
    return text


def _stable_key(query: str, doc_content: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(query.encode("utf-8"))
    h.update(b"\x00")
    h.update(doc_content.encode("utf-8"))
    return h.hexdigest()


class ClassicalReranker:
    """Pluggable-scorer classical reranker with the reference's
    resilience contract."""

    def __init__(
        self,
        config: Optional[ClassicalConfig] = None,
        embedder: Optional[Embedder] = None,
        scorer: Optional[Callable[[str, List[str]], np.ndarray]] = None,
        device=None,
    ):
        self.config = config or ClassicalConfig()
        self.device = resolve_device(device)
        self.embedder = embedder or HashEmbedder(dim=256)
        self._scorer_override = scorer
        self.score_cache: Dict[str, float] = {}
        self._cross_encoder = None  # built at first use
        self._active_method = self.config.method

    def _score_cosine(self, query: str, contents: List[str]) -> np.ndarray:
        embeds = np.asarray(self.embedder([query] + contents), dtype=np.float32)
        e = torch.from_numpy(np.ascontiguousarray(embeds)).to(self.device)
        return cosine_scores(e[:1], e[1:])[0].cpu().numpy()

    def _score_cross_encoder(self, query: str, contents: List[str]) -> np.ndarray:
        if self._cross_encoder is None:
            from qrag_tpu_torch.models.cross_encoder import CrossEncoderScorer

            self._cross_encoder = CrossEncoderScorer.from_config(
                self.config, device=self.device
            )
        if self.config.long_doc_strategy != "chunk_pool":
            return self._cross_encoder.score(query, contents)
        # chunk-and-pool: windows cut at what the tokenizer ingests per
        # piece (max_len minus the CLS/SEP framing and the query's
        # bytes), scored, max-pooled per document
        max_len = self._cross_encoder.cfg.max_len
        q_bytes = min(len(query.encode("utf-8")), (max_len - 3) // 2)
        window = max(32, max_len - 3 - q_bytes)
        pieces: List[str] = []
        owner: List[int] = []
        for di, content in enumerate(contents):
            chunks = [content[i : i + window] for i in range(0, len(content), window)] or [""]
            pieces.extend(chunks)
            owner.extend([di] * len(chunks))
        piece_scores = self._cross_encoder.score(query, pieces)
        out = np.full(len(contents), -np.inf, np.float32)
        for s, di in zip(piece_scores, owner):
            out[di] = max(out[di], float(s))
        return out

    def _score_batch(self, query: str, contents: List[str]) -> np.ndarray:
        if self._scorer_override is not None:
            return np.asarray(self._scorer_override(query, contents))
        if self._active_method == "cross-encoder":
            return self._score_cross_encoder(query, contents)
        return self._score_cosine(query, contents)

    def _retry_once_through(self, query: str, contents: List[str]) -> np.ndarray:
        """One scorer, max_retries attempts with linear backoff."""
        last_err: Optional[Exception] = None
        for attempt in range(self.config.max_retries):
            try:
                t0 = time.time()
                scores = self._score_batch(query, contents)
                logger.debug(
                    "scorer completed in %.3fs for %d pairs",
                    time.time() - t0,
                    len(contents),
                )
                return scores
            except Exception as e:  # noqa: BLE001 - resilience contract
                last_err = e
                logger.warning("prediction attempt %d failed: %s", attempt + 1, e)
                if attempt < self.config.max_retries - 1:
                    time.sleep(0.5 * (attempt + 1))
        raise RuntimeError("all retry attempts failed") from last_err

    def _predict_with_retries(self, query: str, contents: List[str]) -> np.ndarray:
        """Retries, then the fallback chain cross-encoder -> cosine ->
        (the caller's) neutral scores."""
        try:
            return self._retry_once_through(query, contents)
        except RuntimeError:
            if self._scorer_override is not None or self._active_method != "cross-encoder":
                raise  # no further scorer to fall back to
            logger.warning(
                "cross-encoder scorer failed out; falling back to the cosine scorer (sticky)"
            )
            self._active_method = "cosine"
            return self._retry_once_through(query, contents)

    def _neutral(self, documents: List[Document]) -> List[Tuple[Document, float]]:
        """Original order, neutral scores."""
        return [(doc, self.config.neutral_score) for doc in documents]

    def _score_request(self, query_s: str, documents: List[Document], limit: int) -> List[float]:
        """Scores by position (the stable sort sees the documents in
        their original order whatever hit the cache); misses are scored
        in ``batch_size`` batches."""
        scores_by_pos: List[Optional[float]] = [None] * len(documents)
        uncached_pos: List[int] = []
        uncached_contents: List[str] = []
        for pos, doc in enumerate(documents):
            content_s = sanitize_text(doc.content, limit)
            key = _stable_key(query_s, content_s)
            if self.config.enable_cache and key in self.score_cache:
                scores_by_pos[pos] = self.score_cache[key]
            else:
                uncached_pos.append(pos)
                uncached_contents.append(content_s)
        all_scores: List[float] = []
        bs = self.config.batch_size
        for i in range(0, len(uncached_contents), bs):
            batch = uncached_contents[i : i + bs]
            all_scores.extend(float(s) for s in self._predict_with_retries(query_s, batch))
        for pos, content_s, score in zip(uncached_pos, uncached_contents, all_scores):
            if self.config.enable_cache:
                self.score_cache[_stable_key(query_s, content_s)] = score
            scores_by_pos[pos] = score
        return scores_by_pos

    def rerank(
        self,
        query: str,
        documents: List[Document],
        top_k: Optional[int] = None,
    ) -> List[Tuple[Document, float]]:
        start = time.time()
        if not validate_documents(query, documents):
            logger.error("input validation failed - returning neutral scores")
            return self._neutral(documents)

        query_s = sanitize_text(query, self.config.max_sequence_length)
        # "chunk_pool" keeps whole documents, as the reference does
        limit = (
            self.config.max_sequence_length
            if self.config.long_doc_strategy != "chunk_pool"
            else 1 << 24
        )
        try:
            # up to two passes: if the scorer falls back midway, the two
            # scorers' scales are incomparable, so the cache is cleared
            # and the whole request rescored on the fallback
            for _pass in range(2):
                method_before = self._active_method
                scores_by_pos = self._score_request(query_s, documents, limit)
                if self._active_method == method_before:
                    break
                logger.warning(
                    "scorer fell back mid-request (%s -> %s): clearing the score "
                    "cache and rescoring the request on one scale",
                    method_before,
                    self._active_method,
                )
                self.score_cache.clear()
            scored = [(doc, float(s)) for doc, s in zip(documents, scores_by_pos)]
        except Exception as e:  # noqa: BLE001 - resilience contract
            logger.error("scoring failed: %s", e)
            return self._neutral(documents)

        # stable descending sort (ties keep original order), then top_k
        reranked = sorted(scored, key=lambda x: x[1], reverse=True)
        if top_k is not None and top_k > 0:
            reranked = reranked[:top_k]
        logger.info(
            "reranking completed in %.3fs for %d documents",
            time.time() - start,
            len(documents),
        )
        return reranked
