"""The paper's evaluation queries (§4.3) as C-SPARQL text, parsed at load.

* ``q15`` / ``q16`` — SRBench-adapted first-step queries: hierarchy reasoning
  (rdfs:subClassOf) and a length-3 property path, respectively (Table 1).
* ``cquery1`` — the second-step complex query: "how television-show entities
  affect the sentiment analysis of each musical artist when mentioned on the
  same tweet", exercising every SPARQL characteristic the paper lists —
  property path (len 3), CONSTRUCT, UNION, OPTIONAL, hierarchy reasoning and
  KB access (Tables 2-3, Fig. 4).

The ``.rq`` text below is the source of truth; each builder parses it with
:func:`repro_torch.core.sparql.parse_query` against the shared vocabulary, so the
resulting ASTs are guaranteed equal to the former hand-built dataclass
builders (the port's tests pin the AST against the reference parse).  Builders keep their historical
``(vocab, tweet_schema, kb_schema)`` signature: the schema objects intern
exactly the prefixed names the text references, so creating them against the
same vocab is what makes the parsed ids line up with the stream/KB encoders.
"""
from __future__ import annotations

from repro_torch.core import query as Q
from repro_torch.core.rdf import Vocab
from repro_torch.core.sparql import parse_query
from repro_torch.data.dbpedia import KBSchema
from repro_torch.data.tweets import TweetSchema

Q15_RQ = """\
REGISTER QUERY q15 AS
PREFIX schema: <urn:dscep:schema>
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX dbo: <http://dbpedia.org/ontology/>
PREFIX out: <urn:dscep:out>
CONSTRUCT {
  ?tweet out:artistTweet ?ent .
}
FROM STREAM <stream> [RANGE TRIPLES 1000 STEP 1]
FROM <kb>
WHERE {
  ?tweet schema:mentions ?ent .
  GRAPH <kb> {
    ?ent rdf:type/rdfs:subClassOf* dbo:MusicalArtist .
  }
}
"""

Q16_RQ = """\
REGISTER QUERY q16 AS
PREFIX schema: <urn:dscep:schema>
PREFIX dbo: <http://dbpedia.org/ontology/>
PREFIX out: <urn:dscep:out>
CONSTRUCT {
  ?tweet out:code ?cc .
}
FROM STREAM <stream> [RANGE TRIPLES 1000 STEP 1]
FROM <kb>
WHERE {
  ?tweet schema:mentions ?ent .
  GRAPH <kb> {
    ?ent dbo:birthPlace/dbo:country/dbo:countryCode ?cc .
  }
}
"""

CQUERY1_RQ = """\
REGISTER QUERY cquery1 AS
PREFIX schema: <urn:dscep:schema>
PREFIX onyx: <urn:dscep:onyx>
PREFIX rdf: <http://www.w3.org/1999/02/22-rdf-syntax-ns#>
PREFIX rdfs: <http://www.w3.org/2000/01/rdf-schema#>
PREFIX dbo: <http://dbpedia.org/ontology/>
PREFIX out: <urn:dscep:out>
CONSTRUCT {
  ?artist out:coMentionedWith ?show .
  ?artist out:posSentiment ?pos .
  ?artist out:negSentiment ?neg .
  ?artist out:countryCode ?cc .
}
FROM STREAM <stream> [RANGE TRIPLES 1000 STEP 1]
FROM <kb>
WHERE {
  ?tweet schema:mentions ?artist .
  ?tweet schema:mentions ?show .
  ?tweet onyx:positiveEmotion ?pos .
  ?tweet onyx:negativeEmotion ?neg .
  GRAPH <kb> {
    ?artist rdf:type/rdfs:subClassOf* dbo:MusicalArtist .
    ?show rdf:type/rdfs:subClassOf* dbo:TelevisionShow .
    ?artist dbo:birthPlace/dbo:country/dbo:countryCode ?cc .
  }
  { ?tweet schema:likes ?eng . } UNION { ?tweet schema:shares ?eng . }
  OPTIONAL { ?tweet schema:shares ?sh . }
  FILTER(?pos >= 0.00)
}
"""

RQ_TEXTS = {"q15": Q15_RQ, "q16": Q16_RQ, "cquery1": CQUERY1_RQ}


def _check_schemas(vocab: Vocab, ts: TweetSchema, kbs: KBSchema) -> None:
    # the query text resolves prefixed names against `vocab`; the schema
    # handles must have been interned in that same vocab or the parsed ids
    # would silently mismatch the stream/KB encoding
    if (vocab.pred("schema:mentions") != ts.mentions
            or vocab.pred("rdf:type") != kbs.rdf_type):
        raise ValueError(
            "tweet/KB schema was created against a different Vocab than the "
            "one given — paper queries need the shared vocabulary")


def q15(vocab: Vocab, ts: TweetSchema, kbs: KBSchema) -> Q.Query:
    """All tweets mentioning any entity that is a subclass of MusicalArtist."""
    _check_schemas(vocab, ts, kbs)
    return parse_query(Q15_RQ, vocab)


def q16(vocab: Vocab, ts: TweetSchema, kbs: KBSchema) -> Q.Query:
    """For tweets mentioning a musical artist: birthplace -> country -> code."""
    _check_schemas(vocab, ts, kbs)
    return parse_query(Q16_RQ, vocab)


def cquery1(vocab: Vocab, ts: TweetSchema, kbs: KBSchema) -> Q.Query:
    """The paper's CQuery1 (§4.3, second step).

    Correlates musical artists with television shows co-mentioned on the same
    tweet, carrying the tweet's sentiment, the artist's country code (property
    path of length 3), engagement from likes OR shares (UNION), and the
    optional share count (OPTIONAL).  The automatic decomposition
    (:func:`repro_torch.core.planner.decompose`) splits it into the paper's Fig. 4
    shape: an artist-anchored KB operator (QueryA analogue — subclass
    reasoning + property path, the large used-KB slice), a show-anchored KB
    operator (QueryB analogue — subclass reasoning only), and a final
    aggregation operator (QueryG) joining the intermediate binding streams
    with the sentiment/engagement stream patterns (the QueryC-F analogues run
    as dataflow branches inside the aggregator's compiled plan).
    """
    _check_schemas(vocab, ts, kbs)
    return parse_query(CQUERY1_RQ, vocab)
