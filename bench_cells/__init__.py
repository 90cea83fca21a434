"""The port's benchmark cells: ``qrag_tpu_torch`` driven through its
public entry points on one GPU, one cell a configuration under one
traffic mix.

    python -m bench_cells CELL [--seed S] [--device cuda|cpu] [--trace]
    python -m bench_cells.control CELL [--seed S]   # the precision controls
    python -m bench_cells.spread RUNS.jsonl ...     # runs' spread against the bounds

A run makes the rows and queries from ``--seed`` (on the card), gives
the program only those inputs, times the cell's traffic with tracing
off, then holds the answers against the plain reference outside the
timed window.  It prints every end-to-end metric by name with its unit
and bound, the counts, and last one JSON line; it exits 1 when an answer
or a request failed (``common.EXIT_INCORRECT``) and 2 without a card
unless ``--device cpu`` asks for the plain path.  ``--trace`` adds a
traced run after the timed one (``trace.py``): device busy and idle
share, device ms by kernel and by layer, the longest idle gaps by what
the host was doing.  Each cell's module docstring says what its traffic
is and why.
"""

from __future__ import annotations

from typing import NamedTuple


class Cell(NamedTuple):
    module: str
    configuration: str
    source: str  # the published deployment it stands for (<= 200 characters)
    reduced: tuple  # what was cut from it
    chips: int


CELLS = {
    "search_exact_b1024_768d1m": Cell(
        module="bench_cells.search_exact",
        configuration="cohere-768d-1m-flat",
        source="VectorDBBench Performance768D1M (Cohere wikipedia-22-12, 1M x 768, cosine); "
               "rows synthetic from --seed",
        reduced=("the vectors are synthetic unit Gaussian rows from --seed, not Cohere's; "
                 "the row count and width are not cut",),
        chips=1,
    ),
    "search_rerank_b1_1536d500k": Cell(
        module="bench_cells.search_rerank",
        configuration="openai-1536d-500k-flat",
        source="VectorDBBench Performance1536D500K (OpenAI 500K x 1536, cosine); upstream "
               "jon-fox/quantum-rag: OpenAI 1536-d in FAISS IndexFlatL2; rows synthetic "
               "from --seed",
        reduced=("the vectors are synthetic unit Gaussian rows from --seed, not OpenAI's; "
                 "the row count and width are not cut",),
        chips=1,
    ),
}
