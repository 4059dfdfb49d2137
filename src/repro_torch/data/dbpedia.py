"""Synthetic DBpedia-like background KB generator (paper §4.1, dataset B).

Emits the KB structure the paper's queries need:

* a class hierarchy under ``dbo:MusicalArtist`` / ``dbo:TelevisionShow``
  (rdfs:subClassOf, depth <= 3) for hierarchy reasoning (Q15),
* ``rdf:type`` rows linking entities to (sub)classes,
* property-path chains ``entity -> birthPlace -> country -> countryCode``
  (max path length 3, Q16 / CQuery1),
* arbitrary "unused" filler triples so total-KB-size vs used-KB-size
  experiments (Figs. 5-7) can be driven independently.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.kb import KnowledgeBase, kb_from_triples
from repro_torch.core.rdf import Vocab


@dataclasses.dataclass
class KBSchema:
    rdf_type: int
    subclass_of: int
    same_as: int
    birth_place: int
    country: int
    country_code: int
    musical_artist: int       # root class
    television_show: int      # root class

    @staticmethod
    def create(vocab: Vocab) -> "KBSchema":
        return KBSchema(
            rdf_type=vocab.pred("rdf:type"),
            subclass_of=vocab.pred("rdfs:subClassOf"),
            same_as=vocab.pred("owl:sameAs"),
            birth_place=vocab.pred("dbo:birthPlace"),
            country=vocab.pred("dbo:country"),
            country_code=vocab.pred("dbo:countryCode"),
            musical_artist=vocab.term("dbo:MusicalArtist"),
            television_show=vocab.term("dbo:TelevisionShow"),
        )


@dataclasses.dataclass
class KBConfig:
    num_artist_classes: int = 8       # subclasses under MusicalArtist
    num_show_classes: int = 4
    num_artists: int = 128
    num_shows: int = 64
    num_places: int = 32
    num_countries: int = 8
    filler_triples: int = 0           # "unused KB" padding (Figs. 6/7)
    seed: int = 0


@dataclasses.dataclass
class KBData:
    kb: KnowledgeBase
    schema: KBSchema
    artist_ids: np.ndarray
    show_ids: np.ndarray
    rows: np.ndarray          # [n, 3] uint32 (s, p, o) in generation order


def generate_kb(vocab: Vocab, cfg: KBConfig, device="cpu") -> KBData:
    """Same rows as the reference generator for the same config and seed.

    The class/place/country pools are numpy arrays, so each
    ``rng.choice`` draws the same number as over the reference's Python
    lists without converting the list on every draw.
    """
    rng = np.random.default_rng(cfg.seed)
    schema = KBSchema.create(vocab)
    rows: List[Tuple[int, int, int]] = []

    # class hierarchy (depth up to 3: leaf -> mid -> root)
    def hierarchy(root: int, n: int, tag: str) -> List[int]:
        classes = [root]
        mids = []
        for i in range(max(1, n // 3)):
            mid = vocab.term("class:%s:mid%d" % (tag, i))
            rows.append((mid, schema.subclass_of, root))
            mids.append(mid)
            classes.append(mid)
        for i in range(n):
            leaf = vocab.term("class:%s:leaf%d" % (tag, i))
            parent = mids[i % len(mids)] if mids else root
            rows.append((leaf, schema.subclass_of, parent))
            classes.append(leaf)
        return classes

    artist_classes = hierarchy(schema.musical_artist, cfg.num_artist_classes, "artist")
    show_classes = hierarchy(schema.television_show, cfg.num_show_classes, "show")

    places = np.asarray(
        [vocab.term("place:%d" % i) for i in range(cfg.num_places)], np.int64)
    countries = np.asarray(
        [vocab.term("country:%d" % i) for i in range(cfg.num_countries)],
        np.int64)
    for i, c in enumerate(countries.tolist()):
        rows.append((c, schema.country_code, vocab.term("cc:%d" % i)))
    for p in places.tolist():
        rows.append((p, schema.country, int(rng.choice(countries))))
    artist_pool = np.asarray(artist_classes[1:] or artist_classes, np.int64)
    show_pool = np.asarray(show_classes[1:] or show_classes, np.int64)

    artist_ids = []
    for i in range(cfg.num_artists):
        a = vocab.term("artist:%d" % i)
        artist_ids.append(a)
        rows.append((a, schema.rdf_type, int(rng.choice(artist_pool))))
        rows.append((a, schema.birth_place, int(rng.choice(places))))
    show_ids = []
    for i in range(cfg.num_shows):
        s = vocab.term("show:%d" % i)
        show_ids.append(s)
        rows.append((s, schema.rdf_type, int(rng.choice(show_pool))))

    # unused filler (drives the paper's total-KB-size axis)
    filler_pred = vocab.pred("filler:pred")
    for i in range(cfg.filler_triples):
        rows.append(
            (vocab.term("filler:s%d" % (i % 997)), filler_pred, vocab.term("filler:o%d" % i))
        )

    arr = np.asarray(rows, np.uint32).reshape(-1, 3)
    return KBData(
        kb=kb_from_triples(arr, device=device),
        schema=schema,
        artist_ids=np.asarray(artist_ids, np.uint32),
        show_ids=np.asarray(show_ids, np.uint32),
        rows=arr,
    )
