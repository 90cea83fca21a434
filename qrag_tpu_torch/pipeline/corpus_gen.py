"""Deterministic podcast-transcript corpus + retrieval-pair generator
(the port's own copy of ``qrag_tpu.pipeline.corpus_gen``; the same
output, byte for byte).

The bundled artifact ships only vectors + episode ids (119 rows of
``"Piers_Morgan_Uncensored/<sha>"`` — SURVEY.md component 14); the raw
transcripts behind them are not in the image.  This module generates a
*reproducible* text corpus with the same shape as the reference's
ingestion input (shows → episodes → transcript text chunks,
``mcp/server/tools/read_from_s3.py:136-163``) so the learned-embedding
path (bi-encoder training → ``provider="trained"`` → index → recall)
can be trained and evaluated end-to-end with measurable ground truth.

Structure per chunk:
  * a TOPIC: each topic has a doc-side vocabulary and a distinct
    query-side SYNONYM vocabulary (queries paraphrase — string-hash
    embeddings cannot bridge this, a trained encoder can);
  * chunk-specific rare tokens (random letter strings) that
    disambiguate chunks within a topic;
  * filler words.

Queries for a chunk mix synonym-substituted topic words + the chunk's
rare tokens, wrapped in a question template.  Ground truth = the source
chunk's index.  Split by EPISODE so held-out queries target chunks the
trainer never saw.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# doc-side topic vocabularies and their query-side paraphrases
TOPICS: Dict[str, List[str]] = {
    "politics": ["election", "senate", "policy", "campaign", "debate",
                 "ballot", "congress", "governor", "legislation", "poll"],
    "economy": ["inflation", "market", "interest", "recession", "stocks",
                "currency", "trade", "deficit", "employment", "growth"],
    "health": ["vaccine", "hospital", "nutrition", "therapy", "fitness",
               "diagnosis", "pandemic", "wellness", "surgery", "immunity"],
    "technology": ["software", "algorithm", "startup", "encryption",
                   "robotics", "silicon", "network", "quantum", "browser",
                   "satellite"],
    "sports": ["championship", "tournament", "stadium", "transfer",
               "playoff", "referee", "olympics", "marathon", "league",
               "coach"],
    "culture": ["festival", "gallery", "cinema", "novel", "orchestra",
                "sculpture", "theatre", "poetry", "museum", "ballet"],
    "advertising": ["sponsor", "discount", "promotion", "brand",
                    "commercial", "product", "offer", "deal",
                    "subscription", "advertisement"],
    "science": ["telescope", "molecule", "genome", "particle", "fossil",
                "reactor", "climate", "neuron", "enzyme", "asteroid"],
}

# query-side paraphrase of each doc word (deterministic, bijective-ish)
SYNONYMS: Dict[str, str] = {
    "election": "vote", "senate": "chamber", "policy": "doctrine",
    "campaign": "canvass", "debate": "argument", "ballot": "referendum",
    "congress": "parliament", "governor": "premier",
    "legislation": "statute", "poll": "survey",
    "inflation": "prices", "market": "exchange", "interest": "rates",
    "recession": "downturn", "stocks": "equities", "currency": "money",
    "trade": "commerce", "deficit": "shortfall", "employment": "jobs",
    "growth": "expansion",
    "vaccine": "inoculation", "hospital": "clinic", "nutrition": "diet",
    "therapy": "treatment", "fitness": "exercise", "diagnosis": "screening",
    "pandemic": "outbreak", "wellness": "health", "surgery": "operation",
    "immunity": "resistance",
    "software": "program", "algorithm": "procedure", "startup": "venture",
    "encryption": "cipher", "robotics": "automation", "silicon": "chips",
    "network": "internet", "quantum": "qubit", "browser": "client",
    "satellite": "orbiter",
    "championship": "title", "tournament": "cup", "stadium": "arena",
    "transfer": "signing", "playoff": "knockout", "referee": "official",
    "olympics": "games", "marathon": "race", "league": "division",
    "coach": "manager",
    "festival": "carnival", "gallery": "exhibit", "cinema": "film",
    "novel": "book", "orchestra": "symphony", "sculpture": "statue",
    "theatre": "stage", "poetry": "verse", "museum": "archive",
    "ballet": "dance",
    "sponsor": "backer", "discount": "markdown", "promotion": "campaign",
    "brand": "label", "commercial": "spot", "product": "merchandise",
    "offer": "bargain", "deal": "agreement", "subscription": "membership",
    "advertisement": "ad",
    "telescope": "observatory", "molecule": "compound", "genome": "dna",
    "particle": "boson", "fossil": "specimen", "reactor": "plant",
    "climate": "weather", "neuron": "synapse", "enzyme": "protein",
    "asteroid": "comet",
}

_FILLER = ("the guest said that", "and then they discussed", "which was",
           "you know", "frankly speaking", "at some length", "on the show",
           "earlier this week", "in my view", "it turns out")

_LETTERS = np.array(list("abcdefghijklmnopqrstuvwxyz"))


def _rare_token(rng: np.random.RandomState) -> str:
    return "".join(rng.choice(_LETTERS, size=6))


@dataclass
class Chunk:
    text: str
    metadata: str  # "show/episode#chunk"
    episode: int
    topic: str
    rare: List[str]


def generate_corpus(
    n_episodes: int = 32,
    chunks_per_episode: int = 8,
    seed: int = 0,
    show_name: str = "Piers_Morgan_Uncensored",
    episode_names: Optional[Sequence[str]] = None,
) -> List[Chunk]:
    """Deterministic corpus: episodes cycle topics; each chunk gets 3
    chunk-specific rare tokens + ~8 topic words + filler."""
    rng = np.random.RandomState(seed)
    topics = list(TOPICS)
    chunks: List[Chunk] = []
    for ep in range(n_episodes):
        topic = topics[ep % len(topics)]
        if episode_names is not None and ep < len(episode_names):
            ep_name = str(episode_names[ep])
        else:
            ep_name = hashlib.blake2b(
                f"{show_name}/{ep}".encode(), digest_size=8
            ).hexdigest()
        for ci in range(chunks_per_episode):
            rare = [_rare_token(rng) for _ in range(3)]
            words = list(rng.choice(TOPICS[topic], size=6))
            fill = list(rng.choice(_FILLER, size=2))
            # rare (chunk-identifying) tokens go early so byte-level
            # encoders with short max_len always see them
            seq: List[str] = [rare[0], words[0], rare[1], words[1],
                              rare[2], words[2], fill[0], words[3],
                              words[4], fill[1], words[5]]
            text = " ".join(seq)
            chunks.append(
                Chunk(
                    text=text,
                    metadata=f"{show_name}/{ep_name}#c{ci}",
                    episode=ep,
                    topic=topic,
                    rare=rare,
                )
            )
    return chunks


def make_query(chunk: Chunk, rng: np.random.RandomState) -> str:
    """Paraphrased query targeting `chunk`: synonym-substituted topic
    words + one chunk-specific rare token."""
    n_topic = int(rng.randint(2, 4))
    words = list(rng.choice(TOPICS[chunk.topic], size=n_topic, replace=False))
    words = [SYNONYMS.get(w, w) for w in words]
    words.append(chunk.rare[int(rng.randint(len(chunk.rare)))])
    rng.shuffle(words)
    templates = (
        "what did they say about {}",
        "find the segment on {}",
        "when was {} mentioned",
        "{}",
    )
    t = templates[int(rng.randint(len(templates)))]
    return t.format(" ".join(words))


def split_by_episode(
    chunks: List[Chunk], holdout_frac: float = 0.25, seed: int = 1
) -> Tuple[List[int], List[int]]:
    """(train_chunk_idx, held_out_chunk_idx), split on episode ids so
    eval queries target chunks whose episodes were never trained on."""
    rng = np.random.RandomState(seed)
    episodes = sorted({c.episode for c in chunks})
    rng.shuffle(episodes)
    n_hold = max(1, int(len(episodes) * holdout_frac))
    held = set(episodes[:n_hold])
    train_idx = [i for i, c in enumerate(chunks) if c.episode not in held]
    hold_idx = [i for i, c in enumerate(chunks) if c.episode in held]
    return train_idx, hold_idx


def training_pairs(
    chunks: List[Chunk],
    idx: Sequence[int],
    n_pairs: int,
    seed: int = 2,
) -> List[Tuple[str, str]]:
    """(query, positive chunk text) pairs over the given chunk ids."""
    rng = np.random.RandomState(seed)
    pairs = []
    ids = np.asarray(list(idx))
    for _ in range(n_pairs):
        ci = int(ids[rng.randint(len(ids))])
        pairs.append((make_query(chunks[ci], rng), chunks[ci].text))
    return pairs
