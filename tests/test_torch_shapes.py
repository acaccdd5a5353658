"""The port's arrival shapes and workload processes against the reference.

The 13 cases of ``test_shapes.py`` on ``repro_torch.serving.shapes``:
seeded determinism, stream invariants, per-segment rate fidelity, and a
reduced matrix cell driven twice to the same event-journal digest.  The
cell runs the port's ``ServingCluster`` of ``SimEngine`` replicas, as
the reference's does, and dispatches the reference cluster's events; a
bare ``EventLoop`` + ``SimEngine`` loop replays the same arrivals
without the cluster.  Then every shape, and every arrival process of
``workload.py``, yields the reference's seeded ``(t, rid, request)``
stream.
"""

import numpy as np
import pytest

import repro.cluster as jcluster
import repro_torch.cluster as tcluster
from repro.serving import shapes as jshapes
from repro.serving import workload as jwork
from repro.serving.engine import Request as JRequest
from repro_torch.runtime.loop import EventLoop
from repro_torch.serving import workload as twork
from repro_torch.serving.engine import Request
from repro_torch.serving.shapes import SHAPES, ShapedArrivals, make_shape
from repro_torch.serving.simengine import SimEngine

ALL_SHAPES = sorted(SHAPES)


def _stream(name, n=400, rate=8.0, period=40.0, seed=5, lib=None):
    mk = make_shape if lib is None else lib.make_shape
    return mk(name, n, rate=rate, period=period, seed=seed)


def _key(t, req):
    return (t, req.rid, req.prompt.tobytes(), req.max_new_tokens,
            req.slo.name, req.model_id)


# ------------------------------------------------------------ determinism
@pytest.mark.parametrize("name", ALL_SHAPES)
def test_same_seed_bit_identical_stream(name):
    a = [_key(t, r) for t, r in _stream(name)]
    b = [_key(t, r) for t, r in _stream(name)]
    assert a == b


@pytest.mark.parametrize("name", ALL_SHAPES)
def test_reiterable_not_a_spent_iterator(name):
    shape = _stream(name, n=50)
    assert [t for t, _ in shape] == [t for t, _ in shape]


@pytest.mark.parametrize("name", ALL_SHAPES)
def test_different_seed_different_stream(name):
    a = [t for t, _ in _stream(name, seed=5)]
    b = [t for t, _ in _stream(name, seed=6)]
    assert a != b


# ------------------------------------------------------- stream invariants
@pytest.mark.parametrize("name", ALL_SHAPES)
def test_monotone_count_and_rids(name):
    pairs = list(_stream(name))
    assert len(pairs) == 400
    ts = [t for t, _ in pairs]
    assert all(b >= a for a, b in zip(ts, ts[1:]))
    assert ts[0] >= 0.0
    assert [r.rid for _, r in pairs] == list(range(400))
    assert all(isinstance(r, Request) for _, r in pairs)


def test_start_rid_offsets_the_stream():
    shape = make_shape("sawtooth", 10, rate=5.0, seed=1)
    shape.start_rid = 700
    assert [r.rid for _, r in shape] == list(range(700, 710))


def test_rate_max_is_an_envelope():
    for name in ALL_SHAPES:
        shape = _stream(name, n=1)
        ts = np.linspace(0.0, 200.0, 4001)
        assert max(shape.rate(float(t)) for t in ts) <= shape.rate_max + 1e-9


# --------------------------------------------------- segment rate fidelity
@pytest.mark.parametrize("name", ALL_SHAPES)
def test_per_segment_empirical_rate(name):
    """Pool same-rate segments of the nominal profile and hold the
    empirical arrival count to the Poisson expectation (5 sigma)."""
    n, rate = 4000, 20.0
    pairs = list(_stream(name, n=n, rate=rate, period=40.0, seed=9))
    ts = np.asarray([t for t, _ in pairs])
    until = float(ts[-1]) + 1e-9
    pooled = {}  # rounded nominal rate -> [duration, observed]
    profile = _stream(name, n=1, rate=rate, period=40.0)
    for start, end, seg_rate in profile.segments(until):
        key = round(seg_rate, 6)
        dur = end - start
        obs = int(np.sum((ts >= start) & (ts < end)))
        acc = pooled.setdefault(key, [0.0, 0])
        acc[0] += dur
        acc[1] += obs
    assert sum(o for _, o in pooled.values()) == n
    for seg_rate, (dur, obs) in pooled.items():
        exp = seg_rate * dur
        assert abs(obs - exp) <= 5.0 * np.sqrt(exp) + 1.0, (
            f"{name}: pooled rate {seg_rate}: observed {obs} vs "
            f"expected {exp:.1f} over {dur:.1f}s")


@pytest.mark.parametrize("name", ALL_SHAPES)
def test_long_run_mean_tracks_target_rate(name):
    n, rate = 4000, 20.0
    ts = [t for t, _ in _stream(name, n=n, rate=rate, period=40.0, seed=2)]
    assert ts[-1] == pytest.approx(n / rate, rel=0.12)


def test_make_shape_unknown_name():
    with pytest.raises(ValueError, match="unknown shape"):
        make_shape("nope", 10, rate=1.0)


def test_base_class_is_abstract():
    shape = ShapedArrivals(3)
    with pytest.raises(NotImplementedError):
        shape.rate(0.0)


# --------------------------------------------- reduced matrix cell smoke
def _matrix_cell(journal=True, retain_traces=True, seed=3, lib=None):
    """80 ``pulse_spikes`` arrivals onto a ``ServingCluster`` of two
    ``SimEngine`` replicas (batch 8, max_seq 64, decode block 4), as the
    reference drives its cell; ``lib`` runs the reference's cluster."""
    if lib is None:
        C, shapes, dev = tcluster, make_shape, {"device": "cpu"}
    else:
        C, shapes, dev = jcluster, jshapes.make_shape, {}
    fleet = [C.InstanceType("std.1x", 4.0, spot=False) for _ in range(2)]
    cl = C.ServingCluster(None, None, fleet, engine="sim",
                          router=C.RateAwareRouter(place_cap=16),
                          batch_size=8, max_seq=64, decode_block=4,
                          seed=0, journal=journal,
                          retain_traces=retain_traces, **dev)
    cl.attach_arrivals(shapes("pulse_spikes", 80, rate=1.5,
                              period=30.0, seed=seed))
    summary = cl.run(max_time=50_000.0)
    return cl, summary


def test_matrix_cell_journal_bit_identical_across_runs():
    cl1, s1 = _matrix_cell()
    cl2, s2 = _matrix_cell()
    assert cl1.loop.journal == cl2.loop.journal and cl1.loop.journal
    assert cl1.loop.journal_digest == cl2.loop.journal_digest
    assert s1["completed"] == s2["completed"] == 80
    assert s1["tok_per_s"] == s2["tok_per_s"]
    assert s1["p99_latency"] == s2["p99_latency"]


def test_matrix_cell_digest_independent_of_journal_retention():
    """The bounded-memory path (journal=False, streaming metrics) must
    replay the exact same event timeline as the full-capture run."""
    cl_full, s_full = _matrix_cell(journal=True, retain_traces=True)
    cl_lean, s_lean = _matrix_cell(journal=False, retain_traces=False)
    assert cl_lean.loop.journal == []
    assert cl_lean.loop.journal_digest == cl_full.loop.journal_digest
    assert s_lean["completed"] == s_full["completed"]
    assert s_lean["tok_per_s"] == s_full["tok_per_s"]


def test_streaming_cell_keeps_no_per_request_records():
    cl, s = _matrix_cell(retain_traces=False)
    assert s["completed"] == 80
    assert len(cl.metrics.traces) == 0


@pytest.mark.parametrize("retain", [True, False])
def test_matrix_cell_matches_reference(retain):
    """The port's cell dispatches the reference cluster's events and
    reports its summary."""
    cl, s = _matrix_cell(retain_traces=retain)
    ref_cl, ref_s = _matrix_cell(retain_traces=retain, lib="jax")
    assert cl.loop.journal == ref_cl.loop.journal
    assert cl.loop.journal_digest == ref_cl.loop.journal_digest
    assert cl.timeline == ref_cl.timeline
    assert s == ref_s


def _loop_cell(journal=True):
    """The same 80 arrivals onto two bare ``SimEngine``s on one
    ``EventLoop``, no cluster: each arrival schedules the next and lands
    on the engine with the least backlog; a step tick every virtual
    second steps both engines.  Returns (loop, summary)."""
    loop = EventLoop(journal=journal)
    engines = [SimEngine(batch_size=8, max_seq=64, decode_block=4)
               for _ in range(2)]
    summary = {"completed": 0, "tokens": 0}

    def schedule_next(it):
        for at, req in it:
            loop.schedule(at, "arrival", request=req, source=it)
            return

    def on_arrival(ev, t):
        min(engines, key=lambda e: e.backlog_tokens()).submit(
            ev.payload["request"])
        schedule_next(ev.payload["source"])

    def on_step(ev, t):
        for eng in engines:
            eng.step_many(eng.decode_block)
            for req in eng.pop_completed():
                summary["completed"] += 1
                summary["tokens"] += len(req.out_tokens)
        if summary["completed"] < 80:
            loop.schedule(t + 1.0, "step")

    loop.register("arrival", on_arrival)
    loop.register("step", on_step)
    schedule_next(iter(make_shape("pulse_spikes", 80, rate=1.5,
                                  period=30.0, seed=3)))
    loop.schedule(0.0, "step")
    loop.run(until=50_000.0)
    return loop, summary


def test_event_loop_cell_replays_bit_identical():
    full, s_full = _loop_cell()
    again, s_again = _loop_cell()
    lean, s_lean = _loop_cell(journal=False)
    assert full.journal == again.journal and full.journal
    assert full.journal_digest == again.journal_digest \
        == lean.journal_digest
    assert s_full == s_again == s_lean and s_full["completed"] == 80


# ------------------------------------------------ against the reference
@pytest.mark.parametrize("name", ALL_SHAPES)
def test_shape_stream_matches_reference(name):
    ours = [_key(t, r) for t, r in _stream(name, n=300, seed=11)]
    ref = [_key(t, r) for t, r in _stream(name, n=300, seed=11,
                                          lib=jshapes)]
    assert ours == ref
    assert [seg for seg in _stream(name, n=1).segments(120.0)] == \
        [seg for seg in _stream(name, n=1, lib=jshapes).segments(120.0)]


def _reqs(lib_request, n=12, seed=4):
    rng = np.random.default_rng(seed)
    return [lib_request(rid=i, prompt=rng.integers(0, 99, 5)
                        .astype(np.int32), max_new_tokens=3)
            for i in range(n)]


def _pairs(process):
    return [(t, r.rid) for t, r in process]


@pytest.mark.parametrize("spec", ["batch", "poisson:2.5", "trace"])
def test_arrival_processes_match_reference(spec, tmp_path):
    if spec == "trace":
        path = tmp_path / "trace.txt"
        path.write_text("# arrivals\n3.5\n0.25\n1.0  # late\n\n7\n")
        spec = f"trace:{path}"
    ours = twork.make_arrivals(spec, _reqs(Request), seed=9)
    ref = jwork.make_arrivals(spec, _reqs(JRequest), seed=9)
    assert type(ours).__name__ == type(ref).__name__
    assert _pairs(ours) == _pairs(ref)
    with pytest.raises(ValueError, match="unknown arrival spec"):
        twork.make_arrivals("burst", [])
    with pytest.raises(ValueError):
        twork.PoissonArrivals([], 0.0)


def test_closed_loop_think_time_matches_reference():
    ours = twork.ClosedLoopThinkTime(_reqs(Request), n_users=3,
                                     think_mean=2.0, seed=5)
    ref = jwork.ClosedLoopThinkTime(_reqs(JRequest), n_users=3,
                                    think_mean=2.0, seed=5)
    assert [(t, r.rid) for t, r in ours.initial()] == \
        [(t, r.rid) for t, r in ref.initial()]
    t = 0.0
    for rid in (1, 0, 2, 3, 5, 4, 7, 99):
        t += 0.5
        a = ours.on_complete(Request(rid=rid, prompt=np.zeros(1, np.int32)),
                             t)
        b = ref.on_complete(JRequest(rid=rid, prompt=np.zeros(1, np.int32)),
                            t)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a[0], a[1].rid) == (b[0], b[1].rid)
    assert ours.issued == ref.issued and ours.completed == ref.completed


def test_classed_requests_and_slo_classes_match_reference():
    kw = dict(seed=6, interactive_frac=0.4, model_ids=("a", "b"))
    ours = twork.classed_requests(20, 300, **kw)
    ref = jwork.classed_requests(20, 300, **kw)
    assert [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.slo.name,
             r.model_id) for r in ours] == \
        [(r.rid, r.prompt.tolist(), r.max_new_tokens, r.slo.name,
          r.model_id) for r in ref]
    for name, cls in twork.SLO_CLASSES.items():
        j = jwork.SLO_CLASSES[name]
        assert (cls.name, cls.priority, cls.deadline, cls.admit_lazily) \
            == (j.name, j.priority, j.deadline, j.admit_lazily)
