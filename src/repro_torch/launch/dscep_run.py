"""DSCEP pipeline driver: the paper's deployment entry point.

Builds a TweetsKB-like stream and a DBpedia-like KB, registers the chosen
query with a :class:`~repro_torch.core.session.Session` (a named paper
query, or any C-SPARQL ``.rq`` file via ``--rq``), and streams chunks
through the configured execution mode, reporting latency or throughput,
result counts and the used-KB partition sizes.  It runs on the card::

    PYTHONPATH=src python -m repro_torch.launch.dscep_run --query cquery1
    PYTHONPATH=src python -m repro_torch.launch.dscep_run --query q15 \\
        --mode monolithic --method probe --tweets 128
    PYTHONPATH=src python -m repro_torch.launch.dscep_run --mode pipelined
    PYTHONPATH=src python -m repro_torch.launch.dscep_run --rq my_query.rq
    PYTHONPATH=src python -m repro_torch.launch.dscep_run --serve 12

``--mode pipelined`` selects the streaming dataflow runtime: one step per
operator, bounded device channels on every DAG edge, operators placed on
the visible cards by :func:`repro_torch.launch.mesh.place_operators`, and
a schedule that keeps ``--channel-capacity`` chunks in flight; it reports
sustained chunks/s.  ``--serve N`` registers ``N`` standing queries
(:func:`serve_population`) with one ``ServeEngine``.

The flags are the reference launcher's, less ``--pallas`` and
``--no-interpret``: the port has no interpreter and no kernel-free path on
the card (its joins run the hand kernels there, and their plain versions
on the CPU).  ``--fuse`` keeps the reference's meaning and default: off
runs scan joins unfused, through the match-matrix kernel.  ``main``'s
``device`` argument is how a caller (the tests) asks for the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from ..core import paper_queries as PQ
from ..core.rdf import Vocab, to_host_rows
from ..core.session import MODES, ExecutionConfig, Session
from ..core.sparql import SparqlError
from ..data.dbpedia import KBConfig, generate_kb
from ..data.tweets import (
    TweetSchema, TweetStreamConfig, generate_tweets, stream_chunks,
)

QUERIES = {"q15": PQ.Q15_RQ, "q16": PQ.Q16_RQ, "cquery1": PQ.CQUERY1_RQ}


def main(argv=None, device: str = "cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--query", default="cquery1", choices=sorted(QUERIES),
                    help="one of the paper's shipped queries")
    ap.add_argument("--rq", default=None, metavar="FILE.rq",
                    help="run an arbitrary C-SPARQL query file instead of "
                         "a named paper query")
    ap.add_argument("--mode", default="single_program", choices=list(MODES),
                    help="execution mode: monolithic (no decomposition), "
                         "single_program (the whole DAG a chunk at a time) "
                         "or pipelined (per-operator steps over device "
                         "channels)")
    ap.add_argument("--method", default="auto",
                    choices=["scan", "probe", "auto"],
                    help="KB access: the paper's scan/probe methods, or "
                         "cost-based per-join selection from used-KB "
                         "statistics (auto, the default)")
    ap.add_argument("--tweets", type=int, default=96)
    ap.add_argument("--artists", type=int, default=48)
    ap.add_argument("--shows", type=int, default=24)
    ap.add_argument("--filler", type=int, default=1000)
    ap.add_argument("--window-cap", type=int, default=256)
    ap.add_argument("--window-from-query", action="store_true",
                    help="let the query's [RANGE TRIPLES n STEP m] clause "
                         "drive its window geometry instead of --window-cap "
                         "(per-query windows)")
    ap.add_argument("--fuse", action="store_true",
                    help="fused join->compaction (no [M, N] candidate "
                         "matrix)")
    ap.add_argument("--channel-capacity", type=int, default=2,
                    help="slots per inter-operator channel = chunks kept "
                         "in flight (pipelined mode only)")
    ap.add_argument("--placement", default="round_robin",
                    choices=["round_robin", "single"],
                    help="operator->device placement policy (pipelined only)")
    ap.add_argument("--explain", action="store_true",
                    help="print the planner EXPLAIN (join order, per-join "
                         "access method and k_max, estimated fan-out from "
                         "used-KB statistics) and exit without streaming")
    ap.add_argument("--trace", action="store_true",
                    help="enable stage-level tracing + engine metrics; "
                         "prints per-stage latency and per-operator counter "
                         "tables after the stream (fences stage boundaries, "
                         "so throughput numbers include sync overhead)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="multi-query serving mode: register N standing "
                         "queries (paper-query duplicates + filter/class "
                         "variants) with a ServeEngine and stream every "
                         "chunk through all of them, reporting queries/sec "
                         "and the dedup/batching schedule")
    ap.add_argument("--no-dedup", action="store_true",
                    help="serving mode: disable shared-plan dedup and "
                         "prefix sharing (the control arm)")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="pipelined mode: inject a seeded fault plan "
                         "(drops, duplicates, stalls, crashes, corruptions) "
                         "and recover; prints the recovery table after the "
                         "stream")
    ap.add_argument("--checkpoint-every", type=int, default=4, metavar="N",
                    help="chaos mode: operator-checkpoint cadence in "
                         "emitted chunks (0 disables checkpointing)")
    args = ap.parse_args(argv)
    if args.mode == "pipelined" and args.channel_capacity < 2:
        ap.error("--channel-capacity must be >= 2 (double buffering)")
    if args.chaos is not None and args.mode != "pipelined":
        ap.error("--chaos requires --mode pipelined (fault injection needs "
                 "per-operator failure boundaries)")

    vocab = Vocab()
    kbd = generate_kb(vocab, KBConfig(
        num_artists=args.artists, num_shows=args.shows,
        filler_triples=args.filler))
    tweets = TweetSchema.create(vocab)
    pool = np.concatenate([kbd.artist_ids, kbd.show_ids])
    rows = generate_tweets(vocab, tweets, pool, TweetStreamConfig(
        num_tweets=args.tweets, mentions_min=2, mentions_max=4))
    chunks = list(stream_chunks(rows, 4 * args.window_cap))

    faults = recovery = None
    if args.chaos is not None:
        from ..core.faults import FaultPlan
        from ..core.recovery import RecoveryConfig

        # every kind fires against "source" (corrupt_chunk auto-targets
        # "ingest"), so the plan is complete without knowing the query DAG
        faults = FaultPlan.seeded(args.chaos, ("source",),
                                  num_chunks=len(chunks), n_events=5)
        recovery = RecoveryConfig(checkpoint_every=args.checkpoint_every)

    cfg = ExecutionConfig(
        mode=args.mode, window_capacity=args.window_cap, max_windows=4,
        bind_cap=2048, scan_cap=512, out_cap=2048, kb_method=args.method,
        fuse_compaction=args.fuse,
        placement=args.placement, channel_capacity=args.channel_capacity,
        window_from_query=args.window_from_query,
        trace=args.trace,
        faults=faults, recovery=recovery, device=device,
    )
    session = Session(cfg, vocab=vocab, kb=kbd.kb)
    if args.serve:
        return _run_serve(session, chunks, args)
    if args.rq:
        try:
            reg = session.register_file(args.rq)
        except SparqlError as err:
            _report_rq_error(args.rq, err)
            sys.exit(2)
        qname = reg.query.name
    else:
        qname = args.query
        reg = session.register(QUERIES[qname])

    if args.explain:
        from ..obs.report import format_explain
        print(format_explain(reg.explain()))
        return 0

    total_kb = int(kbd.kb.count())
    win, step = reg.window_geometry
    print(f"[dscep] query={qname} method={args.method} mode={args.mode} "
          f"stream={len(rows)} triples in {len(chunks)} chunks, KB={total_kb}")
    print(f"[dscep] window geometry: {win} triples"
          + (f" (STEP {step})" if step else "")
          + (" [from query RANGE clause]" if args.window_from_query else ""))

    if args.mode != "monolithic":
        dag = reg.dag
        print(f"[dscep] operator DAG ({len(dag.subqueries)} operators, "
              f"final={dag.final}):")
        placement = getattr(reg.runtime, "placement", None)
        for name, op in reg.operators.items():
            used = "--" if op.kb is None else int(op.kb.count())
            place = f"  device: {placement[name]}" if placement else ""
            print(f"    {name:40s} used-KB: {used}{place}")

    if args.mode == "pipelined":
        # the whole stream is dispatched software-pipelined; per-chunk
        # latency means nothing here (only the sink is waited on), so
        # report sustained throughput instead
        t0 = time.perf_counter()
        outs, overflow = reg.run(chunks)
        n_out = sum(len(to_host_rows(o)) for o in outs)
        t_total = time.perf_counter() - t0
        clipped = {n: c for n, c in overflow.items() if c}
        print(f"[dscep] pipeline: {len(chunks)} chunks in {t_total:.2f}s "
              f"({len(chunks) / t_total:.2f} chunks/s, includes first-call "
              f"set-up), {args.channel_capacity} in flight")
        print(f"[dscep] overflowed windows per operator: {clipped or 'none'}")
        for edge, st in reg.runtime.channel_stats().items():
            print(f"    {edge:60s} size={st['size']} "
                  f"dropped={st['overflows']}")
        _report_trace(reg, args)
        _report_recovery(reg)
        print(f"[dscep] done: {n_out} output triples, {t_total:.2f}s total")
        return n_out

    n_out = 0
    t_total = 0.0
    for i, chunk in enumerate(chunks):
        t0 = time.perf_counter()
        out, overflow = reg.process_chunk(chunk)
        res = to_host_rows(out)
        dt = time.perf_counter() - t0
        t_total += dt
        n_out += len(res)
        tag = " (includes first-call set-up)" if i == 0 else ""
        ovf = sum(overflow.values())
        print(f"[dscep] chunk {i}: {len(res)} output triples "
              f"in {dt * 1e3:.1f} ms, {ovf} overflowed windows{tag}")
    _report_trace(reg, args)
    print(f"[dscep] done: {n_out} output triples, "
          f"{t_total:.2f}s total")
    return n_out


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


def _run_serve(session, chunks, args):
    eng = session.serve(dedup=not args.no_dedup)
    texts = serve_population(args.serve)
    t0 = time.perf_counter()
    for t in texts:
        eng.register(t)
    t_reg = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs, overflow = eng.run(chunks)
    n_out = sum(
        len(to_host_rows(o)) for per_q in outs.values() for o in per_q)
    t_run = time.perf_counter() - t0
    st = eng.last_stats
    qps = len(texts) * len(chunks) / t_run
    clipped = sum(overflow.values())
    print(f"[serve] {len(texts)} standing queries x {len(chunks)} chunks "
          f"(dedup={'off' if args.no_dedup else 'on'}): "
          f"registered in {t_reg:.2f}s, streamed in {t_run:.2f}s "
          f"= {qps:.1f} query-evals/s (includes first-call set-up)")
    print(f"[serve] schedule: {st['distinct_plans']} distinct plans for "
          f"{st['queries']} queries, shared_plan_hits={st['shared_plan_hits']}, "
          f"shared_prefix_hits={st['shared_prefix_hits']}, "
          f"cohort batch sizes={st['batch_sizes']}, "
          f"singleton operators={st['singletons']}")
    for pg in st["prefix_groups"]:
        print(f"    prefix group ({len(pg['queries'])} plans): "
              f"{pg['prefix_len']} shared steps "
              f"({pg['kb_joins_shared']} KB joins) -> "
              f"{', '.join(pg['queries'][:4])}"
              + ("..." if len(pg["queries"]) > 4 else ""))
    print(f"[serve] done: {n_out} output triples, "
          f"{clipped} overflowed windows")
    return n_out


def _report_rq_error(path, err):
    """Point at the offending ``.rq`` source line for a parse failure."""
    print(f"[dscep] cannot parse {path}: {err}", file=sys.stderr)
    if getattr(err, "line", 0):
        try:
            with open(path) as fh:
                src = fh.read().splitlines()
            bad = src[err.line - 1]
        except (OSError, IndexError):
            return
        print(f"  {err.line:4d} | {bad}", file=sys.stderr)
        print("       | " + " " * max(err.col - 1, 0) + "^", file=sys.stderr)


def _report_recovery(reg):
    """Print the recovery-event table for a fault-injected run."""
    st = reg.last_stats
    rec = st.get("recovery", {})
    if not rec.get("enabled"):
        return
    from ..obs.report import format_recovery_table
    print(format_recovery_table(rec))
    if st.get("degraded"):
        print("[dscep] runtime is DEGRADED: chunks "
              f"{rec['degraded_chunks']} took the lossless channel-free "
              "fallback path")


def _report_trace(reg, args):
    """Print the stage-latency and engine-metric tables for a traced run."""
    if not args.trace:
        return
    from ..obs.report import (
        bottleneck_stage, format_metrics_table, format_stage_table,
    )
    stats = reg.last_stats
    if stats["spans"]:
        print(format_stage_table(stats["spans"]))
        prefix = "stage" if args.mode == "pipelined" else "chunk"
        print("[dscep] bottleneck stage: "
              f"{bottleneck_stage(stats['spans'], prefix=prefix)}")
    if stats["operators"]:
        print(format_metrics_table(stats["operators"]))


if __name__ == "__main__":
    main()
