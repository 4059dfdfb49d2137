"""Synthetic TweetsKB-like RDF stream generator (paper §4.1, dataset A).

Reproduces the structure the paper's queries rely on: each tweet is one RDF
graph event containing mentions (entities linked to the KB), a sentiment
score, and like/share counts; every triple is stamped with the tweet's
creation time.  Sizes are parameterized; defaults target container scale
(the paper streams 60k tweets / 2.3M triples).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core.rdf import TripleBatch, Vocab, make_triples


@dataclasses.dataclass
class TweetSchema:
    """Predicate/vocabulary handles shared by stream and queries."""

    mentions: int
    sentiment_pos: int
    sentiment_neg: int
    likes: int
    shares: int

    @staticmethod
    def create(vocab: Vocab) -> "TweetSchema":
        return TweetSchema(
            mentions=vocab.pred("schema:mentions"),
            sentiment_pos=vocab.pred("onyx:positiveEmotion"),
            sentiment_neg=vocab.pred("onyx:negativeEmotion"),
            likes=vocab.pred("schema:likes"),
            shares=vocab.pred("schema:shares"),
        )


@dataclasses.dataclass
class TweetStreamConfig:
    num_tweets: int = 512
    mentions_min: int = 1
    mentions_max: int = 3
    chunk_tweets: int = 64          # tweets per pulled chunk
    triples_per_tweet_cap: int = 8
    start_ts: int = 1000
    ts_step: int = 1                # monotone timestamps (paper assumption 3)
    seed: int = 0


def generate_tweets(
    vocab: Vocab,
    schema: TweetSchema,
    entity_ids: np.ndarray,
    cfg: TweetStreamConfig,
) -> List[Tuple[int, int, int, int, int]]:
    """All (s,p,o,ts,graph) rows for the configured tweet stream."""
    rng = np.random.default_rng(cfg.seed)
    rows: List[Tuple[int, int, int, int, int]] = []
    for i in range(cfg.num_tweets):
        tweet = vocab.term("tweet:%d" % i)
        ts = cfg.start_ts + i * cfg.ts_step
        graph = i + 1
        k = int(rng.integers(cfg.mentions_min, cfg.mentions_max + 1))
        ments = rng.choice(entity_ids, size=min(k, len(entity_ids)), replace=False)
        for e in ments:
            rows.append((tweet, schema.mentions, int(e), ts, graph))
        rows.append(
            (tweet, schema.sentiment_pos, Vocab.number(float(rng.uniform(0, 5))), ts, graph)
        )
        rows.append(
            (tweet, schema.sentiment_neg, Vocab.number(float(rng.uniform(0, 5))), ts, graph)
        )
        if rng.random() < 0.8:  # likes/shares optional (exercises OPTIONAL)
            rows.append(
                (tweet, schema.likes, Vocab.number(float(rng.integers(0, 1000))), ts, graph)
            )
            rows.append(
                (tweet, schema.shares, Vocab.number(float(rng.integers(0, 500))), ts, graph)
            )
    return rows


def stream_chunks(
    rows: List[Tuple[int, int, int, int, int]],
    chunk_capacity: int,
    device="cpu",
) -> Iterator[TripleBatch]:
    """Chunk rows into fixed-capacity TripleBatches, graph events intact."""
    cur: List[Tuple[int, int, int, int, int]] = []
    i = 0
    while i < len(rows):
        g = rows[i][4]
        graph_rows = []
        j = i
        while j < len(rows) and rows[j][4] == g:
            graph_rows.append(rows[j])
            j += 1
        if len(cur) + len(graph_rows) > chunk_capacity and cur:
            yield make_triples(cur, chunk_capacity, device)
            cur = []
        cur.extend(graph_rows[:chunk_capacity])
        i = j
    if cur:
        yield make_triples(cur, chunk_capacity, device)
