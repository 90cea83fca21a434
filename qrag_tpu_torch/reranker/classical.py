"""Classical reranker (PyTorch port of ``qrag_tpu.reranker.classical``).

The cosine scorer embeds query and documents (pluggable embedder) and
scores by cosine similarity, one matrix product on the device.  The
reference's behavioral contract is kept:
  * input validation failure -> original order, neutral 0.5 scores
  * scorer failure after retries -> original order, neutral scores;
    retries with 0.5 * (attempt + 1) s backoff
  * text sanitation: whitespace collapse + truncation at
    ``max_sequence_length * 4`` chars
  * per-(query, doc) score cache keyed by a stable blake2 content hash
  * stable descending sort + top_k

``method="cross-encoder"`` is not ported yet (ROADMAP.md, Queue 1
slice 3) and raises at construction: raising later, inside the scorer,
would turn the gap into the reference's silent fallback to cosine.
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
        if self.config.method == "cross-encoder" and scorer is None:
            raise NotImplementedError(
                "the cross-encoder scorer is not ported yet (ROADMAP.md, "
                "Queue 1 slice 3); use method='cosine'"
            )
        self.device = resolve_device(device)
        self.embedder = embedder or HashEmbedder(dim=256)
        self._scorer_override = scorer
        self.score_cache: Dict[str, float] = {}

    def _score_cosine(self, query: str, contents: List[str]) -> np.ndarray:
        embeds = np.asarray(self.embedder([query] + contents), dtype=np.float32)
        e = torch.from_numpy(np.ascontiguousarray(embeds)).to(self.device)
        return cosine_scores(e[:1], e[1:])[0].cpu().numpy()

    def _score_batch(self, query: str, contents: List[str]) -> np.ndarray:
        if self._scorer_override is not None:
            return np.asarray(self._scorer_override(query, contents))
        return self._score_cosine(query, contents)

    def _predict_with_retries(self, query: str, contents: List[str]) -> np.ndarray:
        """max_retries attempts with linear backoff."""
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

    def _neutral(self, documents: List[Document]) -> List[Tuple[Document, float]]:
        """Original order, neutral scores."""
        return [(doc, self.config.neutral_score) for doc in documents]

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
            # position slots: the stable sort below sees the documents
            # in their original order whatever hit the cache
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
                all_scores.extend(
                    float(s) for s in self._predict_with_retries(query_s, batch)
                )
            for pos, content_s, score in zip(uncached_pos, uncached_contents, all_scores):
                if self.config.enable_cache:
                    self.score_cache[_stable_key(query_s, content_s)] = score
                scores_by_pos[pos] = score
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
