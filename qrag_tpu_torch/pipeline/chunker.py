"""Text chunking for embedding ingestion (the port's own copy of
``qrag_tpu.pipeline.chunker``).

Reproduces the chunking semantics of the reference's embedding tool
(``mcp/server/tools/fetch_embeddings.py:67-104``): ~4 chars per token,
chunks of at most ``max_tokens * 4`` characters, preferring to break at
a sentence end (``.``), then newline, then space, searched within the
last 500 characters of the window; chunks are stripped.  These exact
boundary rules are observable pipeline behavior (chunk counts determine
index row counts), so they are preserved including edge cases.
"""

from __future__ import annotations

from typing import List

BREAK_WINDOW = 500


_BREAK_CHARS = (".", "\n", " ")  # preference order


def _find_break(text: str, lo: int, hi: int) -> int:
    """Last occurrence of the most-preferred break char in [lo, hi),
    -1 if none — the boundary-preference rule of the reference."""
    for ch in _BREAK_CHARS:
        pos = text.rfind(ch, lo, hi)
        if pos != -1:
            return pos
    return -1


def chunk_text(text: str, max_tokens: int = 8000) -> List[str]:
    """Split ``text`` into chunks of at most ``max_tokens * 4`` chars."""
    limit = max_tokens * 4
    if len(text) <= limit:
        return [text]

    pieces: List[str] = []
    cursor = 0
    n = len(text)
    while cursor < n:
        end = cursor + limit
        if end < n:
            brk = _find_break(text, end - BREAK_WINDOW, end)
            if brk > cursor:
                end = brk + 1
        pieces.append(text[cursor:end].strip())
        cursor = end
    return pieces
