"""The port's cost-model socket server and client (`repro_torch.serving.
{server,client}`), on the CPU.

The reference's concurrency and fault-injection suite
(`tests/test_server.py`) run on the port: the real-model cases on the
port's `CostModelService` (`device="cpu"`, the aggregation kernels' route
on, which on CPU tensors runs their plain versions), the queue, deadline
and shutdown cases on a model-free stub service. Then the wire protocol
across the packages in both directions (the port's client against the
JAX server, the JAX client against the port's server), a scoring error
in the worker thread answered as `worker_failure`, and
`serve_costmodel --listen/--connect` in subprocesses.

Every test carries a deadline (`@pytest.mark.timeout`): a deadlocked
server fails the suite, never hangs it.
"""
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax

from repro.core.evaluate import make_predict_fn as jax_predict_fn
from repro.core.evaluate import predict_kernels as jax_predict_kernels
from repro.core.features import fit_normalizer as jax_fit_normalizer
from repro.core.model import CostModelConfig as JaxConfig
from repro.core.model import cost_model_init as jax_init
from repro.data.synthetic import random_kernel as jax_random_kernel
from repro.serving import CostModelService as JaxService
from repro.serving.client import CostModelClient as JaxClient
from repro.serving.server import CostModelServer as JaxServer
from repro_torch.core import features as F
from repro_torch.core.evaluate import make_predict_fn, predict_kernels
from repro_torch.core.model import CostModelConfig
from repro_torch.core.params import from_jax_params
from repro_torch.data.synthetic import random_kernel
from repro_torch.serving import CostModelService, PredictionCache, \
    RequestCoalescer
from repro_torch.serving.client import (
    ClientError,
    CostModelClient,
    DeadlineExceeded,
    Overloaded,
    ProtocolError,
    WorkerFailure,
)
from repro_torch.serving.server import CostModelServer, FaultPolicy, \
    ServerStats

pytestmark = pytest.mark.timeout(180)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_NODES = 32
JOIN_S = 30            # generous thread-join bound; tests fail, not hang
SIZES = (5, 7, 9, 12, 15, 18)
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world():
    """The reference suite's model, built by JAX from key 0 and carried
    across: the JAX side of the interop tests serves the same weights."""
    graphs = [random_kernel(n, seed=n) for n in SIZES]
    norm = F.fit_normalizer(graphs)
    kw = dict(gnn="graphsage", reduction="column_wise", hidden_dim=16,
              opcode_embed_dim=8, dropout=0.0, max_nodes=MAX_NODES,
              adjacency="sparse")
    jcfg = JaxConfig(**kw)
    jparams = jax_init(jax.random.key(0), jcfg)
    cfg = CostModelConfig(**kw, use_pallas_aggregate=True)
    model = from_jax_params(jax.tree_util.tree_map(np.asarray, jparams),
                            cfg, device="cpu")
    return {"graphs": graphs, "norm": norm, "cfg": cfg, "model": model,
            "predict_fn": make_predict_fn(cfg), "jcfg": jcfg,
            "jparams": jparams}


def _service(world, **kw):
    return CostModelService(world["model"], world["cfg"], world["norm"],
                            predict_fn=world["predict_fn"], **kw)


class StubService:
    """Model-free stand-in implementing the server's service protocol.

    `gate` blocks every scoring call until set (saturation/shutdown
    tests); `started` is set when a scoring call begins. Scores are the
    graphs' node counts, so results stay checkable."""

    def __init__(self, *, blocking: bool = False):
        self.cache = PredictionCache(4096)
        self.gate = threading.Event()
        self.started = threading.Event()
        if not blocking:
            self.gate.set()
        self.coalescer = RequestCoalescer(self._score, node_budget=1 << 30,
                                          on_scored=self.cache.put)

    def _score(self, graphs):
        self.started.set()
        if not self.gate.wait(timeout=JOIN_S):
            raise TimeoutError("test forgot to open the gate")
        return np.array([g.num_nodes for g in graphs], np.float32)

    def submit(self, graphs):
        entries = []
        for g in graphs:
            key = g.canonical_hash()
            val = self.cache.get(key)
            entries.append(self.coalescer.add(key, g) if val is None else val)
        return _StubPending(self, entries)

    def flush(self):
        self.coalescer.flush()

    def stats(self):
        from repro_torch.serving.service import ServiceStats
        return ServiceStats(requests=0, graphs=0, cache=self.cache.stats(),
                            coalesced=self.coalescer.coalesced,
                            flushes=self.coalescer.flushes,
                            flush_sizes=tuple(self.coalescer.flush_sizes))

    def snapshot_cache(self, path):
        return self.cache.snapshot(path)

    def restore_cache(self, path):
        return self.cache.restore(path)


class _StubPending:
    def __init__(self, service, entries):
        self._service, self._entries = service, entries

    def result(self):
        if any(hasattr(e, "ready") and not e.ready for e in self._entries):
            self._service.flush()
        return np.array([e.value if hasattr(e, "ready") else e
                         for e in self._entries], np.float32)


def _start(service, **kw) -> CostModelServer:
    return CostModelServer(service, **kw).start()


def _drain_threads(before):
    """Names of costmodel threads that outlived a stop()."""
    return [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()
            and t.name.startswith("costmodel-server")]


# ---------------------------------------------------------------------------
# Concurrency: N clients x M requests, bit-identical to the direct path
# ---------------------------------------------------------------------------
def test_concurrent_clients_match_direct(world):
    """8 clients x 4 overlapping requests, answered as the direct path
    scores. Within TOL, not bit for bit as in the reference: the flushes
    pack the graphs in another composition than `predict_kernels`, and
    PyTorch's CPU matmul may round a row differently in a product with
    another row count (one ulp, seen here)."""
    graphs = world["graphs"]
    # per-thread request streams: overlapping slices, like interleaved
    # tile-search clients
    streams = [[graphs[i % len(graphs)], graphs[(i + t) % len(graphs)]]
               for t in range(8) for i in range(4)]
    direct = {g.canonical_hash(): s for g, s in zip(
        graphs, predict_kernels(world["model"], world["cfg"], graphs,
                                world["norm"], max_nodes=MAX_NODES,
                                predict_fn=world["predict_fn"]))}
    server = _start(_service(world))
    host, port = server.address
    failures = []

    def client_thread(t):
        try:
            with CostModelClient(host, port) as c:
                for req in streams[t * 4:(t + 1) * 4]:
                    got = c.predict_many(req, deadline_ms=60_000)
                    want = np.array([direct[g.canonical_hash()]
                                     for g in req], np.float32)
                    if not np.allclose(got, want, **TOL):
                        failures.append((t, got, want))
        except Exception as e:                        # noqa: BLE001
            failures.append((t, repr(e)))

    threads = [threading.Thread(target=client_thread, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "client threads hung"
    assert not failures, failures[:3]
    stats = server.stats
    assert stats.completed == 8 * 4
    assert stats.shed_overloaded == 0 and stats.shed_deadline == 0
    server.stop()


def test_cross_client_coalescing(world):
    """Identical graphs sent by different sockets while the worker is
    busy share one coalescer ticket (scored once)."""
    stub = StubService(blocking=True)
    server = _start(stub, coalesce_limit=8)
    host, port = server.address
    g = random_kernel(6, seed=0)
    warm = random_kernel(4, seed=1)
    results = []

    def one_client():
        with CostModelClient(host, port) as c:
            results.append(c.predict_many([g], deadline_ms=60_000))

    # occupy the worker so later requests pile up in the queue
    blocker = threading.Thread(target=lambda: CostModelClient(
        host, port).predict_many([warm], deadline_ms=60_000))
    blocker.start()
    assert stub.started.wait(timeout=JOIN_S)
    stub.gate.clear()                    # next scoring call will block too
    clients = [threading.Thread(target=one_client) for _ in range(4)]
    for t in clients:
        t.start()
    # all 4 duplicates must be queued before the worker drains them
    deadline = threading.Event()
    for _ in range(2000):
        if server._queue.qsize() >= 4:
            break
        deadline.wait(0.005)
    stub.gate.set()
    blocker.join(timeout=JOIN_S)
    for t in clients:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in clients)
    assert len(results) == 4
    assert all(float(r[0]) == g.num_nodes for r in results)
    # 4 identical graphs -> one scored entry; the rest were coalescer
    # shares or cache hits, never separate model scores
    scored = sum(stub.coalescer.flush_sizes)
    assert scored <= 2                   # warm graph + g exactly once
    server.stop()


# ---------------------------------------------------------------------------
# Fault injection: every mode ends in a clean typed error or retry success
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fault_server(world):
    server = _start(_service(world), allow_request_faults=True)
    yield server
    server.stop()


def test_fault_drop_is_clean_error(world, fault_server):
    host, port = fault_server.address
    with CostModelClient(host, port, retries=2, timeout_s=10) as c:
        with pytest.raises(ClientError):
            # the fault rides every resend, so retries exhaust cleanly
            c.inject_fault(world["graphs"][:2], "drop")
        # the connection was dropped, not the server: next call works
        out = c.predict_many(world["graphs"][:2], deadline_ms=60_000)
        assert out.shape == (2,)


def test_fault_delay_still_answers(world, fault_server):
    host, port = fault_server.address
    with CostModelClient(host, port) as c:
        want = c.predict_many(world["graphs"][:3], deadline_ms=60_000)
        got = c.inject_fault(world["graphs"][:3], "delay", delay_s=0.05)
        assert np.array_equal(got, want)


def test_fault_corrupt_frame_is_clean_error(world, fault_server):
    host, port = fault_server.address
    with CostModelClient(host, port, retries=1, timeout_s=10) as c:
        with pytest.raises(ProtocolError):
            c.inject_fault(world["graphs"][:2], "corrupt")
        assert c.predict_many(world["graphs"][:2],
                              deadline_ms=60_000).shape == (2,)


def test_fault_kill_flush_worker_recovers(world, fault_server):
    host, port = fault_server.address
    before = fault_server.stats.worker_failures
    with CostModelClient(host, port, retries=0, timeout_s=10) as c:
        with pytest.raises(WorkerFailure):
            c.inject_fault(world["graphs"][:2], "kill_flush")
        # the scoring pass died; the server did not
        out = c.predict_many(world["graphs"][:2], deadline_ms=60_000)
        assert out.shape == (2,)
    assert fault_server.stats.worker_failures > before


def test_server_side_fault_policy_retry_succeeds(world):
    """A transient server-side fault (one poisoned request) is survived by
    the client's retry: the resend gets a fresh sequence number."""
    server = _start(_service(world),
                    fault_policy=FaultPolicy("corrupt", requests=(1,)))
    host, port = server.address
    with CostModelClient(host, port, retries=2) as c:
        out = c.predict_many(world["graphs"][:2], deadline_ms=60_000)
        assert out.shape == (2,) and c.retried >= 1
    assert server.stats.faults_injected == 1
    server.stop()


def test_fault_policy_validates_mode():
    with pytest.raises(ValueError):
        FaultPolicy("segfault")


# ---------------------------------------------------------------------------
# Admission control: explicit shedding, never hangs, recovers
# ---------------------------------------------------------------------------
def test_overload_sheds_and_recovers():
    stub = StubService(blocking=True)
    server = _start(stub, max_queue=1, coalesce_limit=1)
    host, port = server.address
    results, errors = [], []

    def call(tag, **kw):
        try:
            with CostModelClient(host, port, retries=0, **kw) as c:
                results.append((tag, c.predict_many(
                    [random_kernel(5, seed=0)], deadline_ms=60_000)))
        except ClientError as e:
            errors.append((tag, e))

    # A occupies the worker (scoring blocked on the gate)...
    a = threading.Thread(target=call, args=("A",))
    a.start()
    assert stub.started.wait(timeout=JOIN_S)
    # ...B fills the queue (same graph: it will be a cache hit later)...
    b = threading.Thread(target=call, args=("B",))
    b.start()
    poll = threading.Event()
    for _ in range(2000):
        if server._queue.qsize() >= 1:
            break
        poll.wait(0.005)
    assert server._queue.qsize() >= 1
    # ...C must be shed immediately with an explicit `overloaded`
    with CostModelClient(host, port, retries=0) as c:
        with pytest.raises(Overloaded):
            c.predict_many([random_kernel(7, seed=1)], deadline_ms=60_000)
    assert server.stats.shed_overloaded == 1
    # release the gate: A and B complete, and the server has recovered
    stub.gate.set()
    a.join(timeout=JOIN_S)
    b.join(timeout=JOIN_S)
    assert not a.is_alive() and not b.is_alive()
    assert not errors and len(results) == 2
    with CostModelClient(host, port, retries=0) as c:
        assert c.predict_many([random_kernel(7, seed=1)],
                              deadline_ms=60_000).shape == (1,)
    # full accounting: every admitted request was answered
    s = server.stats
    assert s.requests == s.completed + s.shed_overloaded + s.shed_deadline
    server.stop()


def test_deadline_exceeded_while_queued():
    stub = StubService(blocking=True)
    server = _start(stub, max_queue=4, coalesce_limit=1)
    host, port = server.address
    outcome = {}

    def call_a():
        with CostModelClient(host, port) as c:
            outcome["A"] = c.predict_many([random_kernel(5, seed=0)],
                                          deadline_ms=60_000)

    def call_b():
        try:
            with CostModelClient(host, port, retries=0) as c:
                outcome["B"] = c.predict_many([random_kernel(9, seed=2)],
                                              deadline_ms=1.0)
        except DeadlineExceeded as e:
            outcome["B"] = e

    a = threading.Thread(target=call_a)
    a.start()
    assert stub.started.wait(timeout=JOIN_S)   # worker is busy scoring A
    b = threading.Thread(target=call_b)
    b.start()
    poll = threading.Event()
    for _ in range(2000):                       # B is parked in the queue
        if server._queue.qsize() >= 1:
            break
        poll.wait(0.005)
    poll.wait(0.01)                             # > B's 1ms deadline
    stub.gate.set()
    a.join(timeout=JOIN_S)
    b.join(timeout=JOIN_S)
    assert not a.is_alive() and not b.is_alive()
    assert isinstance(outcome["B"], DeadlineExceeded)
    assert outcome["A"].shape == (1,)
    assert server.stats.shed_deadline == 1
    server.stop()


# ---------------------------------------------------------------------------
# Warm cache: snapshot -> restart -> replay is hit-for-hit exact
# ---------------------------------------------------------------------------
def test_warm_snapshot_restart_replay_exact(world, tmp_path):
    snap = os.fspath(tmp_path / "warm-cache.npz")
    graphs = world["graphs"]
    cold_svc = _service(world)
    server = _start(cold_svc, snapshot_path=snap)
    host, port = server.address
    with CostModelClient(host, port) as c:
        want = c.predict_many(graphs, deadline_ms=60_000)
    server.stop()                               # writes the snapshot
    assert os.path.exists(snap)

    warm_svc = _service(world)
    server2 = _start(warm_svc, snapshot_path=snap)
    assert server2.stats.restored_entries == len(graphs)
    with CostModelClient(*server2.address) as c:
        got = c.predict_many(graphs, deadline_ms=60_000)
    s = warm_svc.stats()
    server2.stop()
    assert np.array_equal(got, want)            # hit-for-hit exact
    assert s.cache.misses == 0 and s.cache.hits == len(graphs)
    assert s.flushes == 0                       # the model was never touched


def test_snapshot_op_roundtrip(world, tmp_path):
    snap = os.fspath(tmp_path / "op-snapshot.npz")
    server = _start(_service(world))
    with CostModelClient(*server.address) as c:
        c.predict_many(world["graphs"][:4], deadline_ms=60_000)
        assert c.snapshot(snap) == 4
    server.stop()
    warm = PredictionCache(64)
    assert warm.restore(snap) == 4


# ---------------------------------------------------------------------------
# Shutdown: in-flight requests answered, no leaked threads or sockets
# ---------------------------------------------------------------------------
def test_shutdown_with_inflight_leaves_nothing_behind():
    before = set(threading.enumerate())
    stub = StubService(blocking=True)
    server = _start(stub, max_queue=8, coalesce_limit=1)
    host, port = server.address
    answered = []

    def call(tag):
        try:
            with CostModelClient(host, port, retries=0, timeout_s=20) as c:
                answered.append((tag, c.predict_many(
                    [random_kernel(5, seed=0)], deadline_ms=60_000)))
        except ClientError as e:
            answered.append((tag, e))

    a = threading.Thread(target=call, args=("inflight",))
    a.start()
    assert stub.started.wait(timeout=JOIN_S)
    b = threading.Thread(target=call, args=("queued",))
    b.start()
    poll = threading.Event()
    for _ in range(2000):
        if server._queue.qsize() >= 1:
            break
        poll.wait(0.005)
    stopper = threading.Thread(target=server.stop)
    stopper.start()
    stub.gate.set()                     # let the in-flight batch finish
    stopper.join(timeout=JOIN_S)
    a.join(timeout=JOIN_S)
    b.join(timeout=JOIN_S)
    assert not stopper.is_alive() and not a.is_alive() and not b.is_alive()
    # both requests were *answered* — scores or a typed error, no silence
    assert len(answered) == 2
    assert _drain_threads(before) == []
    # the listener socket is really gone: a fresh connect must fail
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=2)


def test_stop_is_idempotent(world):
    server = _start(_service(world))
    server.stop()
    server.stop()                               # second stop: clean no-op


def test_client_shutdown_op():
    before = set(threading.enumerate())
    stub = StubService()
    server = _start(stub)
    c = CostModelClient(*server.address)
    c.shutdown()
    # the stop runs in the background; join the server's own threads
    for _ in range(2000):
        if not server.running and _drain_threads(before) == []:
            break
        threading.Event().wait(0.005)
    assert not server.running
    assert _drain_threads(before) == []


# ---------------------------------------------------------------------------
# Protocol hygiene
# ---------------------------------------------------------------------------
def test_garbage_frame_drops_connection_only():
    stub = StubService()
    server = _start(stub)
    host, port = server.address
    raw = socket.create_connection((host, port), timeout=5)
    raw.sendall(struct.pack(">I", 8) + b"notjson!")
    # server closes this connection (recv -> EOF)...
    raw.settimeout(5)
    assert raw.recv(1) == b""
    raw.close()
    # ...but keeps serving fresh ones
    with CostModelClient(host, port) as c:
        assert c.ping() > 0
    server.stop()


def test_oversize_frame_rejected():
    stub = StubService()
    server = _start(stub)
    host, port = server.address
    raw = socket.create_connection((host, port), timeout=5)
    raw.sendall(struct.pack(">I", (64 << 20) + 1))    # absurd length
    raw.settimeout(5)
    assert raw.recv(1) == b""
    raw.close()
    server.stop()


def test_unknown_op_is_bad_request():
    stub = StubService()
    server = _start(stub)
    with CostModelClient(*server.address, retries=0) as c:
        with pytest.raises(ClientError, match="bad_request"):
            c._call({"op": "frobnicate"})
    server.stop()


def test_undecodable_graphs_are_bad_request():
    stub = StubService()
    server = _start(stub)
    with CostModelClient(*server.address, retries=0) as c:
        with pytest.raises(ClientError, match="bad_request"):
            c._call({"op": "predict", "graphs": [{"bogus": 1}]})
    server.stop()


def test_stats_and_ping_ops(world):
    server = _start(_service(world))
    with CostModelClient(*server.address) as c:
        assert c.ping() > 0
        c.predict_many(world["graphs"][:3], deadline_ms=60_000)
        st = c.stats()
    assert st["server"]["completed"] == 1
    assert st["service"]["cache_size"] == 3
    assert st["service"]["flushes"] >= 1
    server.stop()


def test_server_stats_to_dict_roundtrip():
    s = ServerStats(connections=2, requests=5, completed=4,
                    shed_overloaded=1)
    d = s.to_dict()
    assert d["connections"] == 2 and d["shed_overloaded"] == 1
    assert set(d) == {"connections", "requests", "completed",
                      "shed_overloaded", "shed_deadline", "worker_failures",
                      "faults_injected", "restored_entries"}


# ---------------------------------------------------------------------------
# Across the packages: one wire protocol
# ---------------------------------------------------------------------------
def _jax_world(world):
    graphs = [jax_random_kernel(n, seed=n) for n in SIZES]
    norm = jax_fit_normalizer(graphs)
    return graphs, norm


def test_port_client_against_jax_server(world):
    """The port's client scores through a server of the JAX package: the
    answers are the JAX model's own, bit for bit (float32 in a JSON
    double)."""
    jgraphs, jnorm = _jax_world(world)
    jfn = jax_predict_fn(world["jcfg"])
    want = jax_predict_kernels(world["jparams"], world["jcfg"], jgraphs,
                               jnorm, max_nodes=MAX_NODES, predict_fn=jfn)
    service = JaxService(world["jparams"], world["jcfg"], jnorm,
                         predict_fn=jfn)
    server = JaxServer(service).start()
    try:
        with CostModelClient(*server.address) as c:
            assert c.ping() > 0
            got = c.predict_many(world["graphs"], deadline_ms=60_000)
            st = c.stats()
    finally:
        server.stop()
    np.testing.assert_array_equal(got, want)
    assert st["server"]["completed"] == 1


def test_jax_client_against_port_server(world):
    """A client of the JAX package scores through the port's server: the
    port's direct predictions bit for bit, the JAX model's within TOL."""
    jgraphs, jnorm = _jax_world(world)
    direct = predict_kernels(world["model"], world["cfg"], world["graphs"],
                             world["norm"], max_nodes=MAX_NODES,
                             predict_fn=world["predict_fn"])
    server = _start(_service(world))
    try:
        with JaxClient(*server.address) as c:
            assert c.ping() > 0
            got = c.predict_many(jgraphs, deadline_ms=60_000)
            st = c.stats()
    finally:
        server.stop()
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(got, jax_predict_kernels(
        world["jparams"], world["jcfg"], jgraphs, jnorm,
        max_nodes=MAX_NODES), **TOL)
    assert st["service"]["cache_size"] == len(SIZES)


def test_scoring_error_in_the_worker_is_a_worker_failure(world):
    """An error raised by the model in the worker thread (as a CUDA error
    would be) answers the batch with `worker_failure`; nothing falls back
    or retries on the server."""
    calls = []

    def failing(model, batch):
        calls.append(batch)
        raise RuntimeError("CUDA error: an illegal memory access")
    server = _start(CostModelService(world["model"], world["cfg"],
                                     world["norm"], predict_fn=failing))
    try:
        with CostModelClient(*server.address, retries=0) as c:
            with pytest.raises(WorkerFailure, match="CUDA error"):
                c.predict_many(world["graphs"][:2], deadline_ms=60_000)
        assert server.stats.worker_failures == 1 and len(calls) == 1
        assert server.stats.completed == 0
    finally:
        server.stop()


def test_worker_thread_scores_in_inference_mode(world):
    """Grad mode is thread-local: a model whose parameters require grad
    (a trainer's) scores over the socket with the kernels' route on,
    because the predict function enters inference mode in the worker
    thread itself (the kernel wrappers refuse inputs that require grad)."""
    model = from_jax_params(
        jax.tree_util.tree_map(np.asarray, world["jparams"]), world["cfg"],
        device="cpu").requires_grad_(True)
    service = CostModelService(model, world["cfg"], world["norm"],
                               predict_fn=world["predict_fn"])
    server = _start(service)
    try:
        with CostModelClient(*server.address, retries=0) as c:
            got = c.predict_many(world["graphs"], deadline_ms=60_000)
    finally:
        server.stop()
    want = predict_kernels(world["model"], world["cfg"], world["graphs"],
                           world["norm"], max_nodes=MAX_NODES)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# serve_costmodel --listen / --connect
# ---------------------------------------------------------------------------
CLI = [sys.executable, "-m", "repro_torch.launch.serve_costmodel",
       "--programs", "1", "--rounds", "2", "--max-configs", "4",
       "--hidden-dim", "16"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_serve_cli_listen_and_connect(precision, tmp_path):
    snap = str(tmp_path / "warm.npz")
    server = subprocess.Popen(
        CLI + ["--listen", "127.0.0.1:0", "--device", "cpu",
               "--precision", precision, "--snapshot", snap],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        for line in server.stdout:
            lines.append(line)
            m = re.search(r"serving cost model on ([\d.]+):(\d+)", line)
            if m:
                break
        assert m, ("".join(lines), server.stderr.read())
        assert f"precision={precision}" in "".join(lines)
        client = subprocess.run(
            CLI + ["--connect", f"{m.group(1)}:{m.group(2)}"], env=_env(),
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert client.returncode == 0, client.stderr
        assert "queries/s" in client.stdout
        assert re.search(r"completed=\d+ shed=0", client.stdout), \
            client.stdout
    finally:
        server.send_signal(signal.SIGINT)
        out, err = server.communicate(timeout=60)
    assert server.returncode == 0, err
    assert "stopped; served" in out
    assert os.path.exists(snap)


def test_serve_cli_listen_rejects_a_bad_address(capsys):
    from repro_torch.launch.serve_costmodel import main
    with pytest.raises(SystemExit) as e:
        main(["--listen", "nohost", "--device", "cpu"])
    assert e.value.code == 2
    assert "HOST:PORT" in capsys.readouterr().err
