"""Request traces of the port (``repro_torch.obs.trace``) on the CPU: the
span model against the JAX package's copy, and one complete trace per
request through the port's scheduler (after ``tests/test_obs.py``).

The tiling invariant: a trace's child spans partition its root span
``[t_submit, t_done]`` with no gap and no overlap, so their durations sum
to the request's ``latency_s`` exactly.
"""
import numpy as np
import pytest

from repro.obs.trace import RequestTrace as JRequestTrace
from repro_torch.models.so3krates import So3kratesConfig
from repro_torch.obs import TRACER, RequestTrace, configure_tracing
from repro_torch.server import MicroBatchScheduler, SchedulerConfig
from repro_torch.serving import Graph, QuantizedEngine, ServeConfig

CFG = So3kratesConfig(feat=16, vec_feat=4, n_layers=1, n_rbf=4, dir_bits=4,
                      cutoff=3.0)
SERVE4 = ServeConfig(mode="w4a8", bucket_sizes=(16,), max_batch=4,
                     path="dense")
WAIT_S = 120


def _graph(n=10, seed=0, density=0.1):
    rng = np.random.default_rng(seed)
    side = (n / density) ** (1.0 / 3.0)
    return Graph(species=rng.integers(0, CFG.n_species, n).astype(np.int32),
                 coords=rng.uniform(0, side, size=(n, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def engine():
    return QuantizedEngine.from_config(CFG, serve=SERVE4, device="cpu")


@pytest.fixture()
def traced():
    """Enable the port's tracer for one test, drain and disable after."""
    configure_tracing(enabled=True)
    TRACER.reset()
    yield TRACER
    configure_tracing(enabled=False)
    TRACER.reset()


def _assert_complete(doc):
    """One orphan-free span tree whose children tile [t0, t1] exactly."""
    spans = doc["spans"]
    root, children = spans[0], spans[1:]
    assert root["parent_id"] is None and root["t1"] is not None
    assert children, "trace has no child spans"
    for s in children:
        assert s["parent_id"] == root["span_id"] and s["t1"] is not None
    assert children[0]["t0"] == root["t0"]
    assert children[-1]["t1"] == root["t1"]
    for a, b in zip(children, children[1:]):
        assert a["t1"] == b["t0"]


def _script(cls):
    rt = cls("r-1", "request", t0=10.0)
    rt.begin("serve", 11.0, replica=0)
    rt.event("guardrail_flag", 11.2, reason="lee")
    rt.bump_hop()
    rt.begin("queue", 11.5)
    rt.begin("serve", 12.0, replica=2)
    rt.set_attr("bucket", 16)
    rt.finish(13.0, status="ok")
    rt.begin("late", 14.0)                # no-op after finish
    doc = rt.to_json()
    doc.pop("wall_time")
    return doc


class TestTraceModel:
    def test_span_model_matches_jax(self):
        """The same calls give the same document in both packages."""
        doc = _script(RequestTrace)
        assert doc == _script(JRequestTrace)
        assert doc["duration_s"] == 3.0 and doc["hops"] == 1
        assert [s["name"] for s in doc["spans"][1:]] == \
            ["queue", "serve", "queue", "serve"]
        assert [s["attrs"]["hop"] for s in doc["spans"][1:]] == [0, 0, 1, 1]
        _assert_complete(doc)

    def test_tracer_disabled_returns_none(self):
        configure_tracing(enabled=False)
        assert TRACER.start_request() is None

    def test_tracer_collects_and_sinks(self, traced):
        class Sink:
            docs = []

            def write(self, doc):
                self.docs.append(doc)
        sink = Sink()
        configure_tracing(enabled=True, sink=sink)
        tr = traced.start_request(kind="request", t0=0.0)
        tr.finish(1.0)
        assert [d["trace_id"] for d in traced.drain()] == [tr.trace_id]
        assert traced.drain() == []
        assert traced.flush()
        assert [d["trace_id"] for d in sink.docs] == [tr.trace_id]


class TestSchedulerTracing:
    def test_one_complete_trace_per_request(self, engine, traced):
        cfg = SchedulerConfig(max_batch=4, deadline_ms=2.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            handles = [sched.submit(_graph(seed=i)) for i in range(6)]
            results = [h.result(timeout=WAIT_S) for h in handles]
        ids = [r.trace_id for r in results]
        assert all(ids) and len(set(ids)) == 6
        docs = {d["trace_id"]: d for d in traced.drain()}
        assert set(docs) == set(ids)
        for h in handles:
            doc = docs[h.trace.trace_id]
            assert doc["status"] == "ok" and doc["hops"] == 0
            assert doc["attrs"]["bucket"] == 16
            assert [s["name"] for s in doc["spans"][1:]] == ["queue", "serve"]
            _assert_complete(doc)
            # the spans tile the request's latency exactly
            assert sum(s["duration_s"] for s in doc["spans"][1:]) == \
                pytest.approx(h.latency_s, abs=1e-12)
            assert doc["duration_s"] == h.latency_s
        recorded = [tid for f in sched._flushes for tid in f.trace_ids]
        assert sorted(recorded) == sorted(ids)

    def test_rejected_submit_finishes_trace(self, engine, traced):
        cfg = SchedulerConfig(max_batch=4, deadline_ms=2.0, warmup=False)
        with MicroBatchScheduler(engine, cfg) as sched:
            with pytest.raises(ValueError):
                sched.submit(_graph(n=99))
        (doc,) = traced.drain()
        assert doc["status"] == "rejected"
        assert doc["attrs"]["error"] == "ValueError"
        assert traced.n_started == traced.n_finished == 1
        _assert_complete(doc)

    def test_error_trace_finishes_with_status(self, engine, traced):
        class Failing:
            """The engine's surface, with a flush that raises."""
            serve, device = engine.serve, engine.device

            def infer_batch(self, graphs, on_flag=None):
                raise RuntimeError("boom")

            def stats_snapshot(self):
                return {}
        cfg = SchedulerConfig(max_batch=1, deadline_ms=0.0, warmup=False)
        with MicroBatchScheduler(Failing(), cfg) as sched:
            h = sched.submit(_graph())
            with pytest.raises(RuntimeError, match="boom"):
                h.result(timeout=WAIT_S)
        (doc,) = traced.drain()
        assert doc["status"] == "error"
        assert doc["attrs"]["error"] == "RuntimeError"
        _assert_complete(doc)
