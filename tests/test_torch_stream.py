"""The port's live serving session on the CPU (smoke config, 2 slots,
max_seq 64): ``submit`` / ``serve_stream`` against the reference engine's
event stream, and the session's own contract as the reference's
``tests/test_serve_faults.py`` holds it: deadlines (an injected clock),
backpressure, shedding, fault isolation, pages that leak nowhere,
snapshot/restore (greedy and sampled, dense and paged) and
``stream_async``.
"""

import dataclasses
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

from _torch_port import (  # noqa: F401  (fixtures)
    _assert_tokens_match, one_torch_thread, reference_kernels)
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import transformer as TT
from repro_torch.serve import (FinishEvent, FinishReason, Request, ServeConfig, ServeEngine,
                               TokenEvent, stream_async)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RNG = np.random.default_rng(7)
STREAM = [(RNG.integers(0, 512, n).astype(np.int32), m)
          for n, m in [(5, 4), (9, 3), (3, 5), (12, 2), (7, 3)]]
LATE = 4            # submitted at request 0's second token
SC = dict(max_batch=2, max_seq=64)


class FakeClock:
    """An injected clock (seconds) that moves only when the test moves it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _events(eng, reqs, late=None, on_event=None):
    """Submit ``reqs`` (``late``: the index submitted at request 0's second
    token), drain the stream; returns the events as (kind, rid, payload)."""
    rids = [eng.submit(r) for i, r in enumerate(reqs) if i != late]
    out, n0 = [], 0
    for ev in eng.serve_stream():
        if type(ev).__name__ == "TokenEvent":
            out.append(("token", ev.rid, int(ev.token)))
            n0 += ev.rid == 0
            if late is not None and ev.rid == 0 and n0 == 2:
                rids.append(eng.submit(reqs[late]))
        else:
            out.append(("finish", ev.rid, ev.result))
        if on_event is not None:
            on_event(ev)
    return out


def _by_rid(events):
    """{rid: tokens from its TokenEvents}, {rid: its one ServeResult}."""
    toks, results = {}, {}
    for kind, rid, x in events:
        if kind == "token":
            toks.setdefault(rid, []).append(x)
        else:
            assert rid not in results, f"request {rid} finished twice"
            results[rid] = x
    return toks, results


def _assert_stream_consistent(events, n):
    toks, results = _by_rid(events)
    assert sorted(results) == list(range(n))
    for rid, res in results.items():
        np.testing.assert_array_equal(np.asarray(toks.get(rid, []), np.int32), res.tokens)
    return [results[i].tokens for i in range(n)]


@pytest.fixture(scope="module")
def model():
    jcfg = jget("smollm_360m", smoke=True, fused=True)
    cfg = tget("smollm_360m", smoke=True, fused=True)
    with reference_kernels():
        jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = TT.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, params


@pytest.fixture(scope="module")
def clean(model):
    """The dense engine's tokens for STREAM (the ``serve`` of every later
    comparison), and the port's and the reference's mid-flight streams."""
    jcfg, jp, cfg, params = model
    eng = ServeEngine(cfg, params, ServeConfig(**SC), device="cpu")
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    outs = eng.serve(reqs)
    port = _events(ServeEngine(cfg, params, ServeConfig(**SC), device="cpu"), reqs, LATE)
    with reference_kernels():
        ref = _events(JServeEngine(jcfg, jp, JServeConfig(**SC)),
                      [JRequest(p, max_new=m) for p, m in STREAM], LATE)
    return outs, port, ref


def _engine(model, clock=None, **kw):
    return ServeEngine(model[2], model[3], ServeConfig(**SC, **kw), device="cpu", clock=clock)


def test_stream_matches_reference_engine(model, clean):
    """The same event kinds and rids in the same order, the same finish
    reasons; tokens equal or first apart at a reference top-2 near-tie."""
    jcfg, jp, _, _ = model
    outs, port, ref = clean
    assert [(k, r) for k, r, _ in port] == [(k, r) for k, r, _ in ref]
    assert [x.finish.value for k, _, x in port if k == "finish"] == \
        [x.finish.value for k, _, x in ref if k == "finish"]
    got = _assert_stream_consistent(port, len(STREAM))
    ref_toks = [np.asarray(t) for t in _assert_stream_consistent(ref, len(STREAM))]
    _assert_tokens_match(jcfg, jp, STREAM, ref_toks, got, SC["max_seq"])
    for a, b in zip(got, outs):            # mid-flight admission keeps the bits
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv_layout,packed", [("dense", False), ("dense", True),
                                              ("paged", False), ("paged", True)])
def test_serve_equals_drained_stream(model, clean, kv_layout, packed):
    kw = dict(kv_layout=kv_layout, packed_prefill=packed, block_size=8)
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    eng = _engine(model, **kw)
    events = _events(eng, reqs, LATE)
    got = _assert_stream_consistent(events, len(STREAM))
    served = _engine(model, **kw).serve(reqs)
    for a, b, c in zip(got, served, clean[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    st = eng.last_serve_stats
    assert st["requests"] == len(STREAM) and st["finish_reasons"] == {"max_new": 5}
    assert len(st["ttft_ms"]) == len(STREAM)
    assert len(st["token_latency_ms"]) == sum(m for _, m in STREAM) - len(STREAM)
    if kv_layout == "paged":
        assert eng._st.alloc.blocks_in_use() == 0


def test_deadline_midflight_gives_a_partial_output(model, clean):
    clock = FakeClock()
    eng = _engine(model, clock=clock)
    r0 = eng.submit(Request(STREAM[0][0], max_new=4, deadline_ms=50.0))
    r1 = eng.submit(Request(STREAM[2][0], max_new=5))
    n = [0]

    def advance(ev):
        if isinstance(ev, TokenEvent) and ev.rid == r0:
            n[0] += 1
            if n[0] == 2:
                clock.t += 1.0
    _, results = _by_rid(_events(eng, [], on_event=advance))
    res = results[r0]
    assert res.finish is FinishReason.DEADLINE and "mid-decode" in res.detail
    assert 2 <= len(res.tokens) < 4 and res.latency_ms >= 50.0
    np.testing.assert_array_equal(res.tokens, clean[0][0][:len(res.tokens)])
    np.testing.assert_array_equal(results[r1].tokens, clean[0][2])
    assert eng.last_serve_stats["deadline_evictions"] == 1


def test_queued_request_expires_without_a_slot(model, clean):
    clock = FakeClock()
    eng = ServeEngine(model[2], model[3], ServeConfig(max_batch=1, max_seq=64,
                                                      max_queue_wait_ms=100.0),
                      device="cpu", clock=clock)
    r0 = eng.submit(Request(STREAM[0][0], max_new=4))
    r1 = eng.submit(Request(STREAM[1][0], max_new=3))
    moved = [False]

    def advance(ev):
        if isinstance(ev, TokenEvent) and not moved[0]:
            clock.t += 1.0
            moved[0] = True
    _, results = _by_rid(_events(eng, [], on_event=advance))
    assert results[r1].finish is FinishReason.DEADLINE and results[r1].tokens.size == 0
    assert results[r1].ttft_ms is None and results[r1].queue_wait_ms >= 100.0
    np.testing.assert_array_equal(results[r0].tokens, clean[0][0])


def test_queue_overflow_sheds_and_strict_raises(model):
    eng = ServeEngine(model[2], model[3], ServeConfig(max_batch=1, max_seq=64, max_queue=2),
                      device="cpu")
    rids = [eng.submit(Request(p, max_new=2)) for p, _ in STREAM[:3]]
    with pytest.raises(ValueError, match="queue overflow"):
        eng.submit(Request(STREAM[3][0], max_new=2), strict=True)
    _, results = _by_rid(_events(eng, []))
    assert results[rids[2]].finish is FinishReason.SHED
    assert "queue overflow" in results[rids[2]].detail
    assert [results[r].finish for r in rids[:2]] == [FinishReason.MAX_NEW] * 2
    assert eng.last_serve_stats["shed"] == 1


def test_invalid_requests_shed(model, clean):
    eng = _engine(model)
    bad = [Request(np.zeros(0, np.int32)), Request(np.ones(64, np.int32)),
           Request(STREAM[1][0], max_new=0)]
    ok = eng.submit(Request(STREAM[0][0], max_new=4))
    rids = [eng.submit(r) for r in bad]
    with pytest.raises(ValueError, match="empty"):
        eng.submit(bad[0], strict=True)
    _, results = _by_rid(_events(eng, []))
    for rid, needle in zip(rids, ("empty", "max_seq", "max_new")):
        assert results[rid].finish is FinishReason.SHED and needle in results[rid].detail
    np.testing.assert_array_equal(results[ok].tokens, clean[0][0])


def _poison(eng, slot):
    """NaN into one slot's K/V rows of the live cache (dense: its batch row;
    paged: the pages its table maps)."""
    st = eng._st
    with torch.inference_mode():
        for t in st.cache.values():
            if eng._paged:
                t[:, torch.as_tensor(st.slot_blocks[slot])] = float("nan")
            else:
                t[:, slot] = float("nan")


def _slot_of(eng, rid):
    return int(np.flatnonzero(eng._st.sched.slot_req == rid)[0])


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_fault_isolation(model, clean, kv_layout):
    """A NaN in request 2's rows: it finishes FAULT with a prefix of its
    clean tokens, the others keep theirs, and (paged) no page leaks."""
    eng = _engine(model, kv_layout=kv_layout, block_size=8)
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    n = [0]

    def inject(ev):
        if isinstance(ev, TokenEvent) and ev.rid == 2:
            n[0] += 1
            if n[0] == 2:
                _poison(eng, _slot_of(eng, 2))
    toks, results = _by_rid(_events(eng, reqs, on_event=inject))
    res = results[2]
    assert res.finish is FinishReason.FAULT and 2 <= len(res.tokens) < STREAM[2][1]
    np.testing.assert_array_equal(res.tokens, clean[0][2][:len(res.tokens)])
    for i in (0, 1, 3, 4):
        assert results[i].finish is FinishReason.MAX_NEW
        np.testing.assert_array_equal(results[i].tokens, clean[0][i])
    assert eng.last_serve_stats["faults"] == 1
    if kv_layout == "paged":
        alloc = eng._st.alloc
        assert alloc.blocks_in_use() == 0 and int(alloc.refcount.sum()) == 0
        assert set(alloc.free) | set(alloc.cached) == set(range(1, eng._num_blocks))


def test_paged_deadline_evictions_leak_no_block(model):
    clock = FakeClock()
    eng = ServeEngine(model[2], model[3],
                      ServeConfig(max_batch=1, max_seq=64, kv_layout="paged", block_size=8),
                      device="cpu", clock=clock)
    r0 = eng.submit(Request(STREAM[1][0], max_new=6, deadline_ms=500.0))   # 9 tokens: a full block
    r1 = eng.submit(Request(STREAM[0][0], max_new=4, deadline_ms=200.0))
    n = [0]

    def advance(ev):
        if isinstance(ev, TokenEvent) and ev.rid == r0:
            n[0] += 1
            if n[0] == 2:
                clock.t += 1.0
    _, results = _by_rid(_events(eng, [], on_event=advance))
    assert results[r0].finish is FinishReason.DEADLINE and len(results[r0].tokens) == 3
    assert results[r1].finish is FinishReason.DEADLINE and results[r1].tokens.size == 0
    alloc = eng._st.alloc
    assert alloc.blocks_in_use() == 0 and int(alloc.refcount.sum()) == 0
    assert set(alloc.free) | set(alloc.cached) == set(range(1, eng._num_blocks))
    assert eng.last_serve_stats["deadline_evictions"] == 2


@pytest.mark.parametrize("kv_layout,temperature", [("dense", 0.0), ("paged", 0.0),
                                                   ("dense", 0.8), ("paged", 0.8)])
def test_snapshot_restore_bit_identical(model, clean, kv_layout, temperature):
    """Stop the stream after its 6th event (slots busy, requests queued),
    snapshot, pickle, restore on a fresh engine and drain: the tokens of
    the uninterrupted run, the unconsumed events delivered once."""
    kw = dict(kv_layout=kv_layout, block_size=8)
    reqs = [Request(p, max_new=m, temperature=temperature, seed=40 + i)
            for i, (p, m) in enumerate(STREAM)]
    want = (clean[0] if temperature == 0.0
            else _engine(model, **kw).serve([dataclasses.replace(r) for r in reqs]))
    eng = _engine(model, **kw)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    first = []
    for ev in eng.serve_stream():
        first.append(ev)
        if len(first) == 6:
            break
    assert eng._st.queue and eng._st.sched.any_active
    snap = pickle.loads(pickle.dumps(eng.snapshot()))
    del eng
    eng2 = _engine(model, **kw)
    eng2.restore(snap)
    rest = list(eng2.serve_stream())
    toks, results = {}, {}
    for ev in first + rest:
        if isinstance(ev, TokenEvent):
            toks.setdefault(ev.rid, []).append(ev.token)
        else:
            assert ev.rid not in results
            results[ev.rid] = ev.result
    for i, w in enumerate(want):
        np.testing.assert_array_equal(results[i].tokens, w)
        np.testing.assert_array_equal(np.asarray(toks[i], np.int32), w)
    assert eng2.last_serve_stats["requests"] == len(STREAM)


def test_restore_refuses_another_layout_or_device(model):
    eng = _engine(model)
    eng.submit(Request(STREAM[0][0], max_new=2))
    snap = eng.snapshot()
    for kw in (dict(max_batch=4, max_seq=64), dict(max_batch=2, max_seq=64,
                                                   kv_layout="paged")):
        with pytest.raises(ValueError, match="does not match"):
            ServeEngine(model[2], model[3], ServeConfig(**kw), device="cpu").restore(snap)
    with pytest.raises(ValueError, match="device"):
        _engine(model).restore(dict(snap, device_type="cuda"))
    for _ in eng.serve_stream():
        pass


def test_restored_stream_redelivers_unconsumed_events(model, clean):
    eng = ServeEngine(model[2], model[3], ServeConfig(max_batch=1, max_seq=64), device="cpu")
    rid = eng.submit(Request(STREAM[0][0], max_new=1))     # finishes at admission
    stream = eng.serve_stream()
    first = next(stream)
    assert isinstance(first, TokenEvent) and first.rid == rid
    snap = eng.snapshot()
    assert len(snap["pending"]) == 1
    eng2 = ServeEngine(model[2], model[3], ServeConfig(max_batch=1, max_seq=64), device="cpu")
    eng2.restore(snap)
    events = list(eng2.serve_stream())
    assert len(events) == 1 and isinstance(events[0], FinishEvent) and events[0].rid == rid
    assert events[0].result.finish is FinishReason.MAX_NEW
    np.testing.assert_array_equal(events[0].result.tokens, clean[0][0][:1])


def test_stream_async_same_events_and_raises_in_the_consumer(model, clean):
    reqs = [Request(p, max_new=m) for p, m in STREAM]
    eng = _engine(model)
    for r in reqs:
        eng.submit(r)
    got = list(stream_async(eng, backlog=2))
    sync = _engine(model)
    for r in reqs:
        sync.submit(r)
    ref = list(sync.serve_stream())
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert type(a) is type(b) and a.rid == b.rid
        if isinstance(a, TokenEvent):
            assert a.token == b.token
        else:
            assert a.result.finish is b.result.finish
            np.testing.assert_array_equal(a.result.tokens, b.result.tokens)
    # an abandoned iterator stops its worker
    eng = _engine(model)
    for r in reqs:
        eng.submit(r)
    it = stream_async(eng, backlog=1)
    next(it)
    it.close()
    assert not any(t.name == "serve-emit" and t.is_alive() for t in threading.enumerate())
    # a strict-mode error raised in the worker comes out of the consumer's loop
    strict = ServeEngine(model[2], model[3],
                         ServeConfig(max_batch=1, max_seq=64, kv_layout="paged", block_size=8,
                                     num_blocks=2), device="cpu")
    strict.submit(Request(STREAM[3][0], max_new=2))        # 12 tokens: 2 blocks, pool 1
    with pytest.raises(ValueError, match="KV blocks"):
        list(stream_async(strict, strict=True))


def test_olmoe_stream_equals_serve():
    cfg = tget("olmoe_1b_7b", smoke=True)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    reqs = [Request(p, max_new=m) for p, m in STREAM[:3]]
    sc = ServeConfig(max_batch=2, max_seq=32, packed_prefill=True)
    served = ServeEngine(cfg, params, sc, device="cpu").serve(reqs)
    eng = ServeEngine(cfg, params, sc, device="cpu")
    got = _assert_stream_consistent(_events(eng, reqs, late=2), len(reqs))
    for a, b in zip(got, served):
        np.testing.assert_array_equal(a, b)
