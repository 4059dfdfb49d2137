"""Shared fixtures: a small TweetsKB-like stream + DBpedia-like KB world.

NOTE: no XLA_FLAGS manipulation here — tests must see the real single-device
CPU platform (the 512-device trick is exclusively for launch/dryrun.py).

``hypothesis`` is an optional dev dep (requirements-dev.txt); when missing,
a deterministic seeded-fuzz fallback is registered so the nine property-test
modules still collect and run (see tests/_hypothesis_fallback.py).
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))   # tests/ is not a package
import _hypothesis_fallback                     # noqa: E402

_hypothesis_fallback.install()

from repro.core.rdf import Vocab
from repro.data.dbpedia import KBConfig, generate_kb
from repro.data.tweets import TweetSchema, TweetStreamConfig, generate_tweets, stream_chunks


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where none is visible")


class World:
    def __init__(self, num_tweets=40, num_artists=32, filler=200, seed=0):
        self.vocab = Vocab()
        self.kbd = generate_kb(
            self.vocab,
            KBConfig(num_artists=num_artists, num_shows=16, filler_triples=filler, seed=seed),
        )
        self.schema = self.kbd.schema
        self.tweets = TweetSchema.create(self.vocab)
        self.rows = generate_tweets(
            self.vocab, self.tweets, self.kbd.artist_ids,
            TweetStreamConfig(num_tweets=num_tweets, seed=seed),
        )
        self.chunks = list(stream_chunks(self.rows, 256))


@pytest.fixture(scope="session")
def world():
    return World()


@pytest.fixture(scope="session")
def big_world():
    return World(num_tweets=120, num_artists=64, filler=500, seed=1)
