"""The port's shape telemetry (``repro_torch.tunedb.telemetry``) against the
JAX package's: the same record sequence gives the same counts, hot-shape
order and drift; a dump written by either package loads in the other; the
port's dispatch records what the reference's records for the same call;
and a capture that does not count collects without counting."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.tunedb.telemetry as jtel
from repro.kernels import dispatch as jdispatch
from repro.serve import flash_decode as jflash
from repro_torch.core.space import (attention_input, conv_input, gemm_input,
                                    ssd_input)
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.serve import flash_decode as tflash
from repro_torch.tunedb import telemetry as ttel
from repro_torch.tunedb import store as tstore

SHAPES = {
    "gemm": [gemm_input(m, n, 576, 16) for m in (4, 32, 100)
             for n in (192, 576, 1536)],
    "attention": [attention_input(4, 9, 3, 1, 256, 64),
                  attention_input(1, 9, 3, 32, 32, 64)],
    "conv": [conv_input(2, 8, 8, 16, 32, 3, 3, 16)],
    "ssd": [ssd_input(1, 64, 4, 16, 32, 16)],
}


def _sequence(seed, n=400):
    """A numpy-seeded sequence of (space, inputs) calls, skewed so that the
    hot-shape order has ties and a long tail."""
    rng = np.random.default_rng(seed)
    spaces = list(SHAPES)
    out = []
    for _ in range(n):
        space = spaces[int(rng.choice(len(spaces), p=[.6, .2, .1, .1]))]
        shapes = SHAPES[space]
        w = np.arange(len(shapes), 0, -1, dtype=float)
        out.append((space, shapes[int(rng.choice(len(shapes),
                                                  p=w / w.sum()))]))
    return out


def _feed(tel, seq):
    """The same calls through every recording path: locked, buffered (the
    dispatch path), a capture, and tick replays of the captured shapes."""
    third = len(seq) // 3
    for space, x in seq[:third]:
        tel.record(space, x)
    for space, x in seq[third:2 * third]:
        tel.record_buffered(space, x)
    with tel.capture() as cap:
        for space, x in seq[2 * third:]:
            tel.record_buffered(space, x)
    tel.record_ticks(cap.shapes, n=3)
    return cap


def _view(tel):
    return {s: tel.hot_shapes(s, 100) for s in sorted(SHAPES)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_sequence_same_counts_order_and_drift(seed):
    j, t = jtel.ShapeTelemetry(), ttel.ShapeTelemetry()
    seq = _sequence(seed)
    jcap, tcap = _feed(j, seq), _feed(t, seq)
    assert tcap.shapes == jcap.shapes
    assert _view(t) == _view(j)
    assert t.stats() == j.stats()
    assert t.total() == j.total() == len(seq) + 3 * len(tcap.shapes)
    for space, shapes in SHAPES.items():
        assert t.spaces() == j.spaces()
        for x in shapes:
            assert t.count(space, x) == j.count(space, x)
    jprev, tprev = j.snapshot(), t.snapshot()
    assert tprev.total() == jprev.total()
    # a window of different traffic: drift in [0, 1], equal to 1e-12
    later = _sequence(seed + 10, n=150)[::-1]
    for tel in (j, t):
        for space, x in later:
            tel.record_buffered(space, x)
    jd, td = j.diff(jprev), t.diff(tprev)
    assert sorted(td) == sorted(jd)
    for space in jd:
        assert abs(td[space].drift - jd[space].drift) <= 1e-12
        assert td[space].window_calls == jd[space].window_calls
        assert td[space].prev_calls == jd[space].prev_calls
        assert td[space].window_shapes == jd[space].window_shapes
    assert any(0.0 < d.drift < 1.0 for d in td.values())


@pytest.mark.parametrize("written_by", ["reference", "port"])
def test_dump_loads_across_packages(tmp_path, written_by):
    seq = _sequence(4)
    src = (jtel if written_by == "reference" else ttel).ShapeTelemetry()
    _feed(src, seq)
    path = tmp_path / "shapes.json"
    src.save(path)
    assert not (tmp_path / "shapes.json.tmp").exists()
    for mod in (jtel, ttel):
        loaded = mod.ShapeTelemetry.load(path)
        assert _view(loaded) == _view(src)
        assert loaded.stats()["ticks"] == src.stats()["ticks"]
    # merge folds one dump into another, ticks included
    t = ttel.ShapeTelemetry.load(path)
    t.merge(ttel.ShapeTelemetry.load(path))
    assert t.total() == 2 * src.total()
    assert t.stats()["ticks"] == {s: 2 * n for s, n
                                  in src.stats()["ticks"].items()}


def test_uncounted_capture_collects_without_counting():
    """A CUDA graph's capture pass (and its warm-up) traces a tick that
    has not run: its shapes are collected, not counted; each replay then
    counts them."""
    t = ttel.ShapeTelemetry()
    x = SHAPES["gemm"][0]
    t.record_buffered("gemm", x)
    with t.capture(count=False) as cap:
        t.record_buffered("gemm", x)
        t.record("attention", SHAPES["attention"][0])
    assert cap.shapes == [("gemm", x), ("attention", SHAPES["attention"][0])]
    assert t.total() == 1
    t.record_ticks(cap.shapes, n=2)
    assert t.count("gemm", x) == 3 and t.total("attention") == 2
    assert t.stats()["ticks"] == {"gemm": 2, "attention": 2}
    # after the block this thread counts again
    t.record_buffered("gemm", x)
    assert t.count("gemm", x) == 4


def test_a_full_ring_falls_back_and_threads_drain():
    t = ttel.ShapeTelemetry()
    x = SHAPES["gemm"][1]
    for _ in range(ttel.RING_SIZE + 10):
        t.record_buffered("gemm", x)
    assert t.count("gemm", x) == ttel.RING_SIZE + 10

    def work():
        for _ in range(500):
            t.record_buffered("ssd", SHAPES["ssd"][0])
    threads = [threading.Thread(target=work) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.drain_pending() == 2000
    assert t.total("ssd") == 2000
    t.clear()
    assert t.total() == 0 and t.spaces() == []


@pytest.fixture
def both_clear():
    jtel.clear_telemetry()
    ttel.clear_telemetry()
    yield
    jtel.clear_telemetry()
    ttel.clear_telemetry()


def _counts(mod):
    tel = mod.get_telemetry()
    return {s: tel.hot_shapes(s, 100) for s in tel.spaces()}


def test_dispatch_records_what_the_reference_records(both_clear):
    """The same calls through both dispatchers (no store installed) record
    the same (space, inputs) counts: every GEMM, conv, attention and SSD
    call, and every decode split-count lookup."""
    rng = np.random.default_rng(0)
    tstore.install_serving(store=None, models=None, fingerprint=None)
    calls = []
    for m, k, n in ((4, 64, 32), (16, 64, 32), (4, 64, 32)):
        a = rng.normal(size=(m, k)).astype(np.float32)
        b = rng.normal(size=(k, n)).astype(np.float32)
        calls.append(("matmul", a, b))
    x3 = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    i = rng.normal(size=(1, 6, 6, 8)).astype(np.float32)
    f = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
    q = rng.normal(size=(1, 4, 8, 16)).astype(np.float32)
    kv = rng.normal(size=(1, 2, 8, 16)).astype(np.float32)
    xs = rng.normal(size=(1, 16, 2, 8)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, size=(1, 16, 2)).astype(np.float32)
    av = -rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32)
    bm = rng.normal(size=(1, 16, 8)).astype(np.float32)
    for op, a, b in calls:
        jdispatch.matmul(jnp.asarray(a), jnp.asarray(b))
        tdispatch.matmul(torch.as_tensor(a), torch.as_tensor(b))
    jdispatch.matmul2(jnp.asarray(x3), jnp.asarray(w))
    tdispatch.matmul2(torch.as_tensor(x3), torch.as_tensor(w))
    jdispatch.conv2d(jnp.asarray(i), jnp.asarray(f))
    tdispatch.conv2d(torch.as_tensor(i), torch.as_tensor(f))
    jdispatch.flash_attention(jnp.asarray(q), jnp.asarray(kv),
                              jnp.asarray(kv))
    tdispatch.flash_attention(torch.as_tensor(q), torch.as_tensor(kv),
                              torch.as_tensor(kv))
    jdispatch.ssd_scan(*(jnp.asarray(v) for v in (xs, dt, av, bm, bm)))
    tdispatch.ssd_scan(*(torch.as_tensor(v) for v in (xs, dt, av, bm, bm)))
    for mod in (jflash, tflash):
        assert mod.resolve_decode_splits(B=4, Hq=9, Hkv=3, Lkv=256, D=64,
                                         dtype_bits=16, default=4) == 4
    want = _counts(jtel)
    assert _counts(ttel) == want
    assert sum(c for _, c in want["gemm"]) == 4
    assert want["gemm"][0] == (gemm_input(4, 32, 64, 32), 2)
    assert [c for _, c in want["attention"]] == [1, 1]
