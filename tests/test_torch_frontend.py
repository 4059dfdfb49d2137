"""PyTorch port vs the JAX reference: ids, tensors, KB, generators, frontend.

Every comparison is byte equality of ``np.uint32`` arrays: the port keeps
uint32 ids in int64 tensors, so unsigned order and the full ``[0, 2**32)``
range (pads at ``0xFFFFFFFF``, numeric literals above ``2**30``) are pinned
here on values straddling ``2**31``.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kb as rkb
from repro.core import paper_queries as RPQ
from repro.core import pattern as rpat
from repro.core import rdf as rrdf
from repro.core import sparql as rsparql
from repro.data import dbpedia as rdb
from repro.data import tweets as rtw
from repro_torch import interop
from repro_torch.core import kb as pkb
from repro_torch.core import paper_queries as PPQ
from repro_torch.core import pattern as ppat
from repro_torch.core import rdf as prdf
from repro_torch.core import sparql as psparql
from repro_torch.core.stream import merge_streams
from repro_torch.data import dbpedia as pdb
from repro_torch.data import tweets as ptw

QUERY_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "queries")
EDGE = np.array([0, 1, 4095, 4096, 4097, (1 << 20) + 4095, 1 << 21,
                 (1 << 30) - 1, 1 << 30, (1 << 30) + 1, (1 << 31) - 1,
                 1 << 31, (1 << 31) + 1, 0xFFFFFFFE, 0xFFFFFFFF],
                dtype=np.uint64)


def u32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def port_vocab(v: rrdf.Vocab) -> prdf.Vocab:
    return interop.vocab_from_state(v._pred_to_id, v._term_to_id,
                                    v._next_pred, v._next_term)


def port_kb(kb: rkb.KnowledgeBase) -> pkb.KnowledgeBase:
    return interop.kb_from_arrays({f: np.asarray(getattr(kb, f))
                                   for f in kb._fields})


def assert_kb_equal(ref: rkb.KnowledgeBase, port: pkb.KnowledgeBase):
    for f in ref._fields:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).numpy()
        if f == "valid":
            np.testing.assert_array_equal(a, b)
        else:
            assert u32(a).tobytes() == u32(b).tobytes(), f


@pytest.mark.parametrize("pred", [0, 1, 7, 4031, 4095])
def test_composite_key_bytes(pred):
    ref = np.asarray(rrdf.composite_key(jnp.uint32(pred),
                                        jnp.asarray(EDGE.astype(np.uint32))))
    port = prdf.composite_key(pred, torch.from_numpy(EDGE.astype(np.int64)))
    host = pkb.composite_key_np(np.full(len(EDGE), pred, np.uint32),
                                EDGE.astype(np.uint32))
    assert u32(ref).tobytes() == u32(port).tobytes() == host.tobytes()


def test_u32_bit_views_round_trip():
    x = torch.from_numpy(EDGE.astype(np.int64))
    words = prdf.to_u32_bits(x)
    assert words.dtype == torch.int32
    assert words.numpy().view(np.uint32).tobytes() == u32(EDGE).tobytes()
    assert torch.equal(prdf.from_u32_bits(words), x)


@pytest.mark.parametrize("out_cap", [1, 7, 24, 64])
def test_compact_rows_bytes(out_cap):
    rng = np.random.default_rng(out_cap)
    rows = rng.choice(EDGE, size=(40, 3)).astype(np.uint32)
    mask = rng.random(40) < 0.6
    r_rows, r_valid, r_ovf = rpat.compact_rows(jnp.asarray(rows),
                                               jnp.asarray(mask), out_cap)
    p_rows, p_valid, p_ovf = ppat.compact_rows(
        torch.from_numpy(rows.astype(np.int64))[None],
        torch.from_numpy(mask)[None], out_cap)
    assert u32(r_rows).tobytes() == u32(p_rows[0]).tobytes()
    np.testing.assert_array_equal(np.asarray(r_valid), p_valid[0].numpy())
    assert bool(r_ovf) == bool(p_ovf[0])


def test_lexsort_matches_jnp_with_ties_and_high_ids():
    rng = np.random.default_rng(3)
    keys = [rng.choice(EDGE[[0, 9, 11, 14]], size=57).astype(np.uint32)
            for _ in range(3)]
    ref = np.asarray(jnp.lexsort(tuple(jnp.asarray(k) for k in keys)))
    port = prdf.lexsort_order(
        [torch.from_numpy(k.astype(np.int64)) for k in keys])
    np.testing.assert_array_equal(ref, port.numpy())


def test_merge_streams_matches_reference():
    rng = np.random.default_rng(5)
    n = 64
    cols = [rng.choice(EDGE, size=n).astype(np.uint32) for _ in range(3)]
    ts = rng.integers(0, 6, size=n).astype(np.uint32)
    graph = rng.integers(0, 9, size=n).astype(np.uint32)
    valid = rng.random(n) < 0.8
    ref = rrdf.sort_by_timestamp(rrdf.TripleBatch(
        *(jnp.asarray(c) for c in (*cols, ts, graph)), jnp.asarray(valid)))
    port = merge_streams([interop.triples_from_arrays(*cols, ts, graph, valid)])
    for a, b in zip(ref, port):
        assert u32(a).tobytes() == u32(b).tobytes()


@pytest.fixture(scope="module")
def gen_worlds():
    cfg = dict(num_artists=40, num_shows=20, num_places=12, num_countries=5,
               filler_triples=300, seed=4)
    rv, pv = rrdf.Vocab(), prdf.Vocab()
    rk = rdb.generate_kb(rv, rdb.KBConfig(**cfg))
    pk = pdb.generate_kb(pv, pdb.KBConfig(**cfg))
    tcfg = dict(num_tweets=50, mentions_min=1, mentions_max=3, seed=4)
    r_rows = rtw.generate_tweets(rv, rtw.TweetSchema.create(rv),
                                 rk.artist_ids, rtw.TweetStreamConfig(**tcfg))
    p_rows = ptw.generate_tweets(pv, ptw.TweetSchema.create(pv),
                                 pk.artist_ids, ptw.TweetStreamConfig(**tcfg))
    return rv, pv, rk, pk, r_rows, p_rows


def test_generators_give_the_reference_rows(gen_worlds):
    rv, pv, rk, pk, r_rows, p_rows = gen_worlds
    assert np.asarray(rk.rows, np.uint32).tobytes() == pk.rows.tobytes()
    np.testing.assert_array_equal(rk.artist_ids, pk.artist_ids)
    np.testing.assert_array_equal(rk.show_ids, pk.show_ids)
    assert r_rows == p_rows
    assert rv._term_to_id == pv._term_to_id
    assert rv._pred_to_id == pv._pred_to_id
    assert_kb_equal(rk.kb, pk.kb)
    r_chunks = list(rtw.stream_chunks(r_rows, 64))
    p_chunks = list(ptw.stream_chunks(p_rows, 64))
    assert len(r_chunks) == len(p_chunks) > 1
    for rc, pc in zip(r_chunks, p_chunks):
        for a, b in zip(rc, pc):
            assert u32(a).tobytes() == u32(b).tobytes()
        assert rrdf.to_host_rows(rc) == prdf.to_host_rows(pc)


def _straddling_rows(rng, n=300):
    """KB rows whose subjects/objects straddle 2**31 and the numeric band."""
    s = rng.choice(np.concatenate([
        np.arange(4096, 4200), np.arange((1 << 31) - 50, (1 << 31) + 50),
        np.arange(0xFFFFFF00, 0xFFFFFFFF)]), size=n)
    p = rng.integers(1, 6, size=n)
    o = rng.choice(np.concatenate([
        np.arange(4096, 4120), np.arange((1 << 30), (1 << 30) + 40),
        np.arange((1 << 31) - 20, (1 << 31) + 20)]), size=n)
    return np.stack([s, p, o], axis=1).astype(np.uint32)


def test_kb_arrays_stats_prune_pad_and_probe_match_reference():
    rng = np.random.default_rng(11)
    rows = _straddling_rows(rng)
    ref = rkb.build_kb(rows[:, 0], rows[:, 1], rows[:, 2], capacity=320)
    port = pkb.build_kb(rows[:, 0], rows[:, 1], rows[:, 2], capacity=320)
    assert_kb_equal(ref, port)
    assert rkb.collect_kb_stats(ref) == pkb.collect_kb_stats(port)
    narrow = {2: {int(rows[0, 2]), int(rows[5, 2])}}
    assert_kb_equal(rkb.prune(ref, [1, 2, 4], narrow),
                    pkb.prune(port, [1, 2, 4], narrow))
    assert_kb_equal(rkb.pad_to(ref, 400), pkb.pad_to(port, 400))
    assert (rkb.host_rows(ref).astype(np.uint32).tobytes()
            == pkb.host_rows(port).tobytes())
    q = rng.choice(np.asarray(ref.key_ps), size=50)
    r_lo, r_hi = rkb.probe_range(ref.key_ps, jnp.asarray(q))
    p_lo, p_hi = pkb.probe_range(port.key_ps, torch.from_numpy(
        q.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(r_lo), p_lo.numpy())
    np.testing.assert_array_equal(np.asarray(r_hi), p_hi.numpy())


def test_kb_words_hold_the_reference_bits_and_are_built_once():
    rows = _straddling_rows(np.random.default_rng(12))
    ref = rkb.build_kb(rows[:, 0], rows[:, 1], rows[:, 2], capacity=320)
    port = pkb.build_kb(rows[:, 0], rows[:, 1], rows[:, 2], capacity=320)
    words = port.words
    assert words is port.words
    assert words.valid is port.valid
    for f in ref._fields:
        if f != "valid":
            assert getattr(words, f).dtype == torch.int32
            assert (getattr(words, f).numpy().tobytes()
                    == u32(getattr(ref, f)).tobytes()), f
    padded = pkb.pad_to(port, 400)
    assert padded.words is not words
    assert_kb_equal(rkb.pad_to(ref, 400), pkb.KnowledgeBase(*(
        prdf.from_u32_bits(c) if c.dtype == torch.int32 else c
        for c in padded.words)))


def _rq_texts():
    texts = dict(RPQ.RQ_TEXTS)
    for path in sorted(glob.glob(os.path.join(QUERY_DIR, "*.rq"))):
        with open(path) as f:
            texts[os.path.basename(path)] = f.read()
    return texts


@pytest.mark.parametrize("name", sorted(_rq_texts()))
def test_parse_and_serialize_match_reference(name):
    text = _rq_texts()[name]
    rv = rrdf.Vocab()
    rdb.KBSchema.create(rv)
    rtw.TweetSchema.create(rv)
    pv = port_vocab(rv)
    rq, rinfo = rsparql.parse_query_info(text, rv)
    pq, pinfo = psparql.parse_query_info(text, pv)
    assert repr(rq) == repr(pq)          # dataclass reprs: same AST shape
    assert (rsparql.serialize_query(rq, rv, dict(rinfo.prefixes), info=rinfo)
            == psparql.serialize_query(pq, pv, dict(pinfo.prefixes), info=pinfo))
    assert psparql.parse_query(psparql.serialize_query(pq, pv), pv) == pq
    assert rv._pred_to_id == pv._pred_to_id
    assert rv._term_to_id == pv._term_to_id


def test_paper_query_builders_match_text():
    pv = prdf.Vocab()
    kbs = pdb.KBSchema.create(pv)
    ts = ptw.TweetSchema.create(pv)
    for build, text in ((PPQ.q15, PPQ.Q15_RQ), (PPQ.q16, PPQ.Q16_RQ),
                        (PPQ.cquery1, PPQ.CQUERY1_RQ)):
        assert build(pv, ts, kbs) == psparql.parse_query(text, pv)


def test_interop_vocab_round_trip():
    rv = rrdf.Vocab()
    rdb.KBSchema.create(rv)
    rv.term("x:1")
    pv = port_vocab(rv)
    assert pv.to_str(rv.term("x:1")) == "x:1"
    assert pv.pred("rdf:type") == rv.pred("rdf:type")
    assert pv.term("x:new") == rv.term("x:new")
    assert pv.num_terms == rv.num_terms
