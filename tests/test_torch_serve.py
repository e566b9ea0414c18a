"""Serving in wiser_tpu_torch: the gRPC server over a real loopback channel
(test_serve.py's cases, on a port chosen free at run time), whose answers
and snippets equal the OracleEngine's, and which the JAX package's stub
and the port's closed-loop client both talk to; the BatchingExecutor
under many threads; the engine factory's URLs; the query pool and the
latency histogram (test_bench_infra.py's cases against the JAX
package's); and a subprocess without grpc and protobuf that imports the
server module and serves a batch through the BatchingExecutor on the
CPU."""

import os
import socket
import subprocess
import sys
import threading

import grpc
import numpy as np
import pytest

from wiser_tpu.bench import histogram as j_hist
from wiser_tpu.bench import query_pool as j_pool
from wiser_tpu.serve import wiser_pb2 as j_pb
from wiser_tpu.serve.protocol import WiserEngineStub as JStub
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.bench.histogram import Histogram, format_latency_table
from wiser_tpu_torch.bench.query_pool import (
    QueryLogReader,
    QueryProducer,
    QueryProducerByLog,
    QueryProducerNoLoop,
    parse_query_line,
    write_query_log,
)
from wiser_tpu_torch.data.synth import synth_docinfos
from wiser_tpu_torch.engine.factory import create_search_engine
from wiser_tpu_torch.index.builder import build_index
from wiser_tpu_torch.index.doc_store import ChunkedDocStoreWriter, LazyDocBodies
from wiser_tpu_torch.index.oracle_dump import serialize
from wiser_tpu_torch.serve import wiser_pb2 as pb
from wiser_tpu_torch.serve.client import Client
from wiser_tpu_torch.serve.protocol import WiserEngineStub
from wiser_tpu_torch.serve.server import (
    BatchingExecutor,
    OracleExecutorAdapter,
    create_server,
    warmup_engine,
)
from wiser_tpu_torch.types import SearchQuery

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def triples(entries):
    return [(e.doc_id, e.doc_score, e.snippet) for e in entries]


@pytest.fixture(scope="module")
def corpus():
    return build_index(synth_docinfos(n_docs=200, vocab_size=60, mean_len=25,
                                      seed=2))


@pytest.fixture(scope="module")
def served(corpus):
    packed, oracle = corpus
    engine = TorchEngine(packed, device="cpu", doc_bodies=oracle.doc_bodies)
    port = free_port()
    server, executor = create_server(engine, port, n_threads=8,
                                     max_wait_ms=1.0, warmup=True)
    server.start()
    channel = grpc.insecure_channel(f"localhost:{port}")
    grpc.channel_ready_future(channel).result(timeout=30)
    yield oracle, engine, port, channel
    channel.close()
    executor.stop()
    server.stop(grace=1)


@pytest.fixture(scope="module")
def stub(served):
    return WiserEngineStub(served[3])


def test_echo_and_read_only(stub):
    assert stub.Echo(pb.EchoData(message="ping")).message == "ping"
    reply = stub.AddDocument(pb.AddDocumentRequest(body="x", tokens="x"))
    assert not reply.ok  # a packed engine is immutable


@pytest.mark.parametrize("terms,phrase,snip", [
    (["t0"], False, False), (["t0"], False, True), (["t1", "t2"], False, True),
    (["t0", "t1"], True, True), (["t2", "t0", "t1"], False, False),
    (["zzz"], False, True), (["t0", "zzz"], False, False)])
def test_unary_equals_the_oracle(served, stub, terms, phrase, snip):
    oracle = served[0]
    q = SearchQuery(terms, n_results=10, is_phrase=phrase,
                    return_snippets=snip, n_snippet_passages=2)
    reply = stub.UnarySearch(pb.SearchRequest(
        terms=terms, n_results=10, is_phrase=phrase, return_snippets=snip,
        n_snippet_passages=2))
    assert triples(reply.entries) == triples(oracle.search(q).entries)
    assert (not snip or not reply.entries
            or all("<b>" in e.snippet for e in reply.entries))


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for size in (4, 1, 17):
        qs = []
        for _ in range(size):
            nt = int(rng.integers(1, 4))
            qs.append(SearchQuery([f"t{rng.integers(0, 25)}" for _ in range(nt)],
                                  n_results=int(rng.integers(1, 12)),
                                  is_phrase=bool(nt > 1 and rng.random() < 0.3),
                                  return_snippets=bool(rng.random() < 0.5)))
        out.append(qs)
    return out


def test_batch_search_equals_the_oracle(served, stub):
    """N queries per wire message: replies come back per message, in
    order, equal to the oracle's."""
    from wiser_tpu_torch.serve.protocol import request_from_query

    oracle = served[0]
    batches = _batches()

    def gen():
        for qs in batches:
            b = pb.SearchRequestBatch()
            b.requests.extend(request_from_query(q) for q in qs)
            yield b

    replies = list(stub.BatchSearch(gen()))
    assert [len(r.replies) for r in replies] == [len(qs) for qs in batches]
    for qs, rep in zip(batches, replies):
        for q, r in zip(qs, rep.replies):
            assert triples(r.entries) == triples(oracle.search(q).entries)


def test_streaming_and_the_jax_stub(served):
    """Round trips on the bidirectional stream; the JAX package's stub and
    messages talk to the port's server (one wire format)."""
    oracle, _, _, channel = served
    terms_list = (["t0"], ["t1", "t2"], ["t3"])

    for stub_cls, msgs in ((WiserEngineStub, pb), (JStub, j_pb)):
        replies = list(stub_cls(channel).StreamingSearch(
            msgs.SearchRequest(terms=t, n_results=5) for t in terms_list))
        assert len(replies) == 3
        for t, r in zip(terms_list, replies):
            want = oracle.search(SearchQuery(list(t), n_results=5)).entries
            assert triples(r.entries) == triples(want)


def test_closed_loop_client(served, tmp_path):
    """The port's client, unary and wire-batched, against the server."""
    port = served[2]
    qs = [SearchQuery(["t0"]), SearchQuery(["t1", "t2"]),
          SearchQuery(["t0", "t1"], is_phrase=True)]
    path = str(tmp_path / "log.txt")
    write_query_log(path, qs)
    for kw in (dict(streaming=False), dict(wire_batch=8)):
        client = Client(f"localhost:{port}",
                        QueryProducer(QueryLogReader(path).read_all(), 2),
                        n_threads=2, duration_s=0.5, n_channels=1, **kw)
        stats = client.run()
        for c in client.channels:
            c.close()
        assert stats["total"] > 0 and stats["histogram"].count > 0


def test_batching_executor_many_threads(corpus):
    """64 threads through one executor: every answer equals the oracle's,
    snippets included, whatever batch it landed in; the engine saw fewer
    batches than requests."""
    packed, oracle = corpus
    engine = TorchEngine(packed, device="cpu", doc_bodies=oracle.doc_bodies)
    calls = []
    orig = engine.submit_batch

    def counting(queries):
        calls.append(len(queries))
        return orig(queries)

    engine.submit_batch = counting
    ex = BatchingExecutor(engine, max_batch=64, max_wait_ms=5.0)
    rng = np.random.default_rng(8)
    qs = [SearchQuery([f"t{i % 7}", f"t{rng.integers(0, 20)}"][: 1 + i % 2],
                      n_results=5, return_snippets=i % 3 == 0)
          for i in range(192)]
    results = {}

    def worker(tid):
        mine = qs[tid::64]
        if tid % 2:
            results.update(zip(range(tid, 192, 64), ex.search_many(mine)))
        else:
            for i, q in zip(range(tid, 192, 64), mine):
                results[i] = ex.search(q)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(64)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    ex.stop()
    assert sorted(results) == list(range(192))
    for i, q in enumerate(qs):
        assert triples(results[i].entries) == triples(oracle.search(q).entries)
    assert sum(calls) == 192 and len(calls) < 192


def test_executor_drives_the_oracle_and_reports_errors(corpus, tmp_path):
    """OracleExecutorAdapter (search_batch only) and the batch trace; an
    engine error reaches the request's future."""
    _, oracle = corpus
    trace = str(tmp_path / "trace.jsonl")
    ex = BatchingExecutor(OracleExecutorAdapter(oracle), trace_path=trace)
    q = SearchQuery(["t0", "t1"], n_results=4, return_snippets=True)
    assert triples(ex.search(q).entries) == triples(oracle.search(q).entries)
    ex.stop()
    assert open(trace).read().count('"n": 1') == 1

    class Broken:
        def search_batch(self, queries):
            raise ValueError("boom")

    ex = BatchingExecutor(Broken())
    with pytest.raises(ValueError):
        ex.search(q, timeout=10)
    ex.stop()


def test_warmup_engine(corpus):
    packed, oracle = corpus
    engine = TorchEngine(packed, device="cpu")
    assert warmup_engine(engine, batch_sizes=(4, 16)) == 20
    assert warmup_engine(OracleExecutorAdapter(oracle)) == 0


# -- the factory ---------------------------------------------------------------


def test_factory_urls(corpus, tmp_path):
    packed, oracle = corpus
    assert create_search_engine("oracle:").n_docs == 0
    serialize(oracle, str(tmp_path / "dump"))
    assert create_search_engine(f"oracle:{tmp_path / 'dump'}").n_docs == 200
    path = str(tmp_path / "c.linedoc")
    from wiser_tpu_torch.linedoc import write_linedoc

    docs = synth_docinfos(30, 20, 10, seed=1)
    write_linedoc(path, [["d", d.body, d.tokens, d.token_offsets,
                          d.token_positions] for d in docs])
    eng = create_search_engine(f"oracle_linedoc:{path}:WITH_POSITIONS")
    assert eng.n_docs == 30

    d = str(tmp_path / "idx")
    packed.save(d)
    q = SearchQuery(["t0", "t1"], n_results=5, return_snippets=True)
    plain = create_search_engine(f"torch:{d}", device="cpu")
    assert plain.doc_bodies is None and plain.columns == "raw"
    assert all(e.snippet == "" for e in plain.search(q).entries)
    w = ChunkedDocStoreWriter(f"{d}/docs")
    for body in oracle.doc_bodies:
        w.add(body)
    w.close()
    for url, cols in ((f"torch:{d}", "raw"), (f"torch_tc:{d}", "tc")):
        eng = create_search_engine(url, device="cpu")
        assert isinstance(eng.doc_bodies, LazyDocBodies) and eng.columns == cols
        got = triples(eng.search(q).entries)
        assert got == triples(oracle.search(q).entries) and got
    with pytest.raises(NotImplementedError, match="A.11"):
        create_search_engine(f"sharded:{d}:2")
    with pytest.raises(ValueError):
        create_search_engine("bogus:x")
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError):
            create_search_engine(f"torch:{d}")  # "cuda" by default


# -- the query pool and the histogram -------------------------------------------


@pytest.mark.parametrize("line", ["hello world\n", '"new york"', "   \n",
                                  '""', "a  b", '"solo"'])
def test_query_line_parsing_equals_the_jax_package(line):
    got, want = parse_query_line(line), j_pool.parse_query_line(line)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.terms, got.is_phrase) == (want.terms, want.is_phrase)


def test_query_log_and_producers(tmp_path):
    queries = [SearchQuery(["a"]), SearchQuery(["b", "c"]),
               SearchQuery(["d", "e"], is_phrase=True)]
    p = str(tmp_path / "log.txt")
    write_query_log(p, queries)
    jp = str(tmp_path / "jlog.txt")
    j_pool.write_query_log(jp, queries)
    assert open(p).read() == open(jp).read()
    back = QueryLogReader(p).read_all(n_results=7)
    assert [(q.terms, q.is_phrase, q.n_results) for q in back] == \
        [(q.terms, q.is_phrase, 7) for q in queries]
    qs = [SearchQuery([f"t{i}"]) for i in range(5)]
    prod = QueryProducer(qs, n_threads=2)
    seen = [prod.next_query(0).terms[0] for _ in range(6)]
    assert seen == ["t0", "t2", "t4", "t0", "t2", "t4"]  # loops, round robin
    noloop = QueryProducerNoLoop(qs[:3])
    got = [noloop.next_query() for _ in range(5)]
    assert [g.terms[0] if g else None for g in got] == \
        ["t0", "t1", "t2", None, None]
    assert noloop.is_empty()
    by_log = QueryProducerByLog(p)
    assert by_log.next_query().terms == ["a"]


def test_histogram_equals_the_jax_package():
    rng = np.random.default_rng(4)
    vals = rng.lognormal(12, 1.5, size=3000)
    a, b = Histogram(), j_hist.Histogram()
    halves = Histogram(), Histogram()
    for i, v in enumerate(vals):
        a.add(v)
        b.add(v)
        halves[i % 2].add(v)
    m = Histogram.merged(halves)
    for p in (0, 25, 50, 75, 90, 95, 99, 100):
        assert a.percentile(p) == b.percentile(p) == m.percentile(p)
    assert a.summary() == b.summary()
    assert format_latency_table(a) == j_hist.format_latency_table(b)
    h = Histogram()
    for v in range(1, 1001):
        h.add(v * 1000.0)
    assert h.percentile(0) == 1000.0 and h.percentile(100) == 1000000.0
    assert 450_000 < h.percentile(50) < 550_000  # ~1% bucket error
    assert Histogram().percentile(50) == 0.0


# -- without grpc and protobuf ---------------------------------------------------


_NO_GRPC = """
import sys
sys.modules["grpc"] = None
sys.modules["google"] = None
sys.path.insert(0, {root!r})
from wiser_tpu_torch import TorchEngine
from wiser_tpu_torch.data.synth import synth_docinfos
from wiser_tpu_torch.index.builder import build_index
from wiser_tpu_torch.serve.server import BatchingExecutor
from wiser_tpu_torch.types import SearchQuery

packed, oracle = build_index(synth_docinfos(120, 40, 20, seed=3))
engine = TorchEngine(packed, device="cpu", doc_bodies=oracle.doc_bodies)
ex = BatchingExecutor(engine, max_batch=64, max_wait_ms=2.0)
qs = [SearchQuery(["t0", "t%d" % i], n_results=5, return_snippets=i % 2 == 0)
      for i in range(1, 30)]
got = ex.search_many(qs)
ex.stop()
for q, r in zip(qs, got):
    want = oracle.search(q).entries
    assert [(e.doc_id, e.doc_score, e.snippet) for e in r.entries] == \\
        [(e.doc_id, e.doc_score, e.snippet) for e in want]
assert any(r.entries for r in got)
bad = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("grpc", "wiser_tpu", "jax", "jaxlib")
    or m.startswith("google.protobuf")))
assert not bad, bad
print("OK")
"""


def test_executor_without_grpc_or_protobuf():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", _NO_GRPC.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
