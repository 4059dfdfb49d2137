"""The DSCEP launcher's serving population.

For now this module holds only the standing-query population the serving
benchmark registers (:func:`serve_population`); the launcher itself, its
flags and its ``main``, are ``ROADMAP.md`` queue 1 item 8 ("Launcher,
presets and benchmarks").
"""
from __future__ import annotations


_SERVE_BASE = """\
REGISTER QUERY %(name)s AS
PREFIX schema: <urn:dscep:schema>
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX dbo: <http://dbpedia.org/ontology/>
PREFIX out: <urn:dscep:out>
CONSTRUCT { ?tweet out:entityCode ?cc . }
FROM STREAM <stream> [RANGE TRIPLES 1000 STEP 1]
FROM <kb>
WHERE {
  ?tweet schema:mentions ?ent .
  GRAPH <kb> {
    ?ent rdf:type/rdfs:subClassOf* dbo:%(cls)s .
    ?ent dbo:birthPlace/dbo:country/dbo:countryCode ?cc .
  }
}
"""

_SERVE_FILT = """\
REGISTER QUERY %(name)s AS
PREFIX schema: <urn:dscep:schema>
PREFIX out: <urn:dscep:out>
CONSTRUCT { ?tweet out:hot ?ent . }
FROM STREAM <stream> [RANGE TRIPLES 1000 STEP 1]
WHERE {
  ?tweet schema:mentions ?ent .
  ?tweet schema:likes ?l .
  FILTER(?l >= %(thresh)s)
}
"""


def serve_population(n: int):
    """``n`` standing-query texts exercising all three sharing tiers:
    exact duplicates (plan dedup), class variants (shared KB-join prefix)
    and filter-threshold variants (constant cohort)."""
    texts = []
    classes = ("MusicalArtist", "TelevisionShow")
    for i in range(n):
        kind = i % 3
        if kind == 0:       # duplicates of one base query -> dedup
            texts.append(_SERVE_BASE % {"name": "dup%d" % i,
                                        "cls": "MusicalArtist"})
        elif kind == 1:     # alternating classes -> shared KB-join prefix
            texts.append(_SERVE_BASE % {"name": "cls%d" % i,
                                        "cls": classes[(i // 3) % 2]})
        else:               # distinct thresholds -> constant cohort
            texts.append(_SERVE_FILT % {"name": "thr%d" % i,
                                        "thresh": "%.1f" % (1.0 + (i // 3))})
    return texts
