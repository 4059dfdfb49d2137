"""RDF stream plumbing: the Aggregator's merge/order stage."""
from __future__ import annotations

from typing import Sequence

from .rdf import TripleBatch, concat_triples, sort_by_timestamp


def merge_streams(chunks: Sequence[TripleBatch]) -> TripleBatch:
    """Merge K stream chunks into one timestamp-ordered chunk.

    Concatenation + stable sort by (invalid last, ts, graph).  The sort
    always runs: on input already in merge order it is the identity, and
    skipping it would need a host sync to decide.
    """
    batch = chunks[0] if len(chunks) == 1 else concat_triples(list(chunks))
    return sort_by_timestamp(batch)
