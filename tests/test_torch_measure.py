"""The port's serving-path re-measurement (``repro_torch.tunedb.measure``)
against the JAX package's: the same pushes and drains of a
``MeasureQueue`` with the same measurer give the same winners, counters,
model memo entries and plan-overlay promotions; the simulated mode is
refused; the measurer times through the correctness gate."""

import numpy as np
import pytest

import repro.tunedb.model as jmodel
import repro.tunedb.store as jstore
from repro.tunedb.measure import MeasureQueue as JQueue
from repro_torch.core.backend import CheckedBackend
from repro_torch.core.search import enumerate_legal
from repro_torch.core.space import GEMM_SPACE, ConfigRejected, gemm_input
from repro_torch.tunedb import model as tmodel
from repro_torch.tunedb import store as tstore
from repro_torch.tunedb.measure import MeasureQueue as TQueue
from repro_torch.tunedb.measure import ServingMeasurer

FP = "repro_torch-cuda-test"
SHAPES = [gemm_input(17, 576, 576, 16), gemm_input(100, 192, 576, 16),
          gemm_input(64, 1536, 576, 16), gemm_input(9, 576, 1536, 16)]


@pytest.fixture(autouse=True)
def _clean_serving_state():
    for mod in (jstore, tstore):
        mod.install_serving(store=None, models=None, fingerprint=None,
                            build_plan=False)
    yield
    for mod in (jstore, tstore):
        mod.install_serving(store=None, models=None, fingerprint=None,
                            build_plan=False)


def _candidates(inputs, k=5, seed=0):
    """``k`` launchable configs of the port's space at ``inputs``."""
    legal = enumerate_legal(GEMM_SPACE, inputs)
    rng = np.random.default_rng(seed + inputs["M"])
    return [legal[int(i)] for i in rng.permutation(len(legal))[:k]]


class StubMeasurer:
    """Deterministic TFLOPS from the config; the gate rejects every
    ``k_split`` 8 config (and every config of ``reject_all``'s shape)."""

    def __init__(self, reject_all=None):
        self.calls = []
        self.reject_all = reject_all

    def __call__(self, space, cfg, inputs):
        self.calls.append((space, dict(cfg), dict(inputs)))
        if cfg["k_split"] == 8 or dict(inputs) == self.reject_all:
            raise ConfigRejected(f"gate: {cfg}")
        return (cfg["bm"] * 0.01 + cfg["bn"] * 0.002 + cfg["bk"] * 0.0003
                - cfg["k_split"] * 0.05 + cfg["prefetch"] * 0.001)


def _drive(queue_cls, store_mod, model_mod, measurer):
    """The same pushes and drains against one package; returns what each
    step returned, the stats, the memo and the plan's entries."""
    store_mod.install_serving(store=store_mod.RecordStore(), models=None,
                              fingerprint=FP)
    models = model_mod.ModelSet()
    q = queue_cls(maxlen=3)
    cands = {i: _candidates(x) for i, x in enumerate(SHAPES)}
    # a k_split=8 config at the top of one list: rejected, never the winner
    cands[1][0] = dict(cands[1][0], k_split=8)
    steps = [q.push("gemm", FP, SHAPES[0], cands[0]),
             q.push("gemm", FP, SHAPES[0], cands[0]),       # deduped
             q.push("gemm", FP, SHAPES[1], cands[1]),
             q.push("gemm", FP, SHAPES[2], cands[2]),
             q.push("gemm", FP, SHAPES[3], cands[3]),       # full: dropped
             len(q),
             q.process(measurer, models=models, max_items=2),
             q.push("gemm", FP, SHAPES[3], cands[3]),
             q.process(measurer, models=models, max_items=2),
             q.process(measurer, models=models, max_items=2),
             len(q)]
    plan = store_mod.serving_state().plan
    entries = [plan.lookup("gemm", tuple(sorted(x.items()))) for x in SHAPES]
    return steps, q.stats(), dict(models._memo), entries


def test_queue_matches_the_reference():
    """The same pushes and drains with the same measurer give the same
    returns, stats, memo entries and plan-overlay promotions in both
    packages; a rejected candidate drops out, and a shape whose candidates
    are all rejected keeps no entry."""
    runs = []
    for qcls, smod, mmod in ((JQueue, jstore, jmodel),
                             (TQueue, tstore, tmodel)):
        measurer = StubMeasurer(reject_all=SHAPES[2])
        runs.append(_drive(qcls, smod, mmod, measurer) + (measurer.calls,))
    (jsteps, jstats, jmemo, jentries, jcalls), \
        (tsteps, tstats, tmemo, tentries, tcalls) = runs
    assert tsteps == jsteps == [True, False, True, True, False, 3, 2, True,
                                2, 0, 0]
    assert tstats == jstats
    assert tstats["pushed"] == 4 and tstats["processed"] == 4
    assert tstats["dropped"] == 1 and tstats["backlog"] == 0
    assert tcalls == jcalls and len(tcalls) == 4 * 5
    assert tmemo == jmemo and len(tmemo) == 3
    assert tentries == jentries
    assert tentries[2] is None                        # all rejected
    for x, entry in zip(SHAPES, tentries):
        if entry is None:
            continue
        key = ("gemm", FP, tuple(sorted(x.items())))
        assert entry == (tmemo[key][0], "model")
        assert entry[0]["k_split"] != 8
    assert tstats["upgrades"] >= 1


def test_queue_drain_stays_off_a_plan_the_store_outgrew():
    """A measured winner goes into the memo but not into a plan compiled
    before the store's last append (the plan stands aside until the next
    install), in both packages."""
    got = []
    for qcls, smod, mmod in ((JQueue, jstore, jmodel),
                             (TQueue, tstore, tmodel)):
        store = smod.RecordStore()
        smod.install_serving(store=store, models=None, fingerprint=FP)
        x = SHAPES[0]
        store.add(smod.TuneRecord(space="gemm", inputs=SHAPES[1],
                                  config=_candidates(SHAPES[1])[0],
                                  tflops=1.0, backend=FP))
        models, q = mmod.ModelSet(), qcls()
        q.push("gemm", FP, x, _candidates(x))
        assert q.process(StubMeasurer(), models=models) == 1
        plan = smod.serving_state().plan
        got.append((plan.lookup("gemm", tuple(sorted(x.items()))),
                    dict(models._memo)))
    assert got[0] == got[1]
    assert got[1][0] is None and len(got[1][1]) == 1


def test_a_measurement_that_fails_otherwise_raises():
    """Only a gate rejection skips a candidate in the port: any other
    failure of a measurement propagates (the reference swallows it)."""
    def broken(space, cfg, inputs):
        raise RuntimeError("launch failed")

    q = TQueue()
    q.push("gemm", FP, SHAPES[0], _candidates(SHAPES[0]))
    with pytest.raises(RuntimeError, match="launch failed"):
        q.process(broken)


@pytest.mark.parametrize("mode,match", [("sim", "TPU v5e"),
                                        ("roofline", "pick one of")])
def test_a_mode_other_than_wallclock_is_refused(mode, match):
    with pytest.raises(ValueError, match=match):
        ServingMeasurer(mode, device="cpu")


def test_the_engine_refuses_sim_before_installing_anything(tmp_path):
    from repro_torch.configs import smollm_135m
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, ServeConfig
    import torch
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(smollm_135m.SMOKE, gen)
    before = tstore.serving_state().generation
    with pytest.raises(ValueError, match="TPU v5e"):
        Engine(smollm_135m.SMOKE, params, ServeConfig(
            max_len=16, slots=1, tunedb=str(tmp_path / "db.jsonl"),
            measure="sim"), device="cpu")
    assert tstore.serving_state().generation == before


def test_the_measurer_times_through_the_gate():
    """The measurer is ``CheckedBackend(CudaEventBackend)`` on its
    device (here the CPU, asked for by name): a config is gated, then
    timed; each measurement counts once."""
    m = ServingMeasurer(device="cpu")
    assert isinstance(m.backend, CheckedBackend)
    assert m.backend.timer.device.type == "cpu"
    x = gemm_input(17, 64, 48, 32)
    cfg = _candidates(x, k=1)[0]
    assert m("gemm", cfg, x) > 0.0
    assert m.stats() == {"mode": "wallclock", "counts": {"wallclock": 1}}


def test_merged_models_keep_the_measure_queue():
    """A retrain's merged set keeps the serving set's measurer and queue,
    an empty queue included (the reference's ``or`` drops a queue of
    length 0 and keeps only a non-empty one)."""
    measurer = StubMeasurer()
    for qcls, mmod in ((JQueue, jmodel), (TQueue, tmodel)):
        old = mmod.ModelSet(measurer=measurer, remeasure_top_k=6)
        old.measure_queue = qcls()
        old.measure_queue.push("gemm", FP, SHAPES[0], _candidates(SHAPES[0]))
        merged = old.merged_with(mmod.ModelSet())
        assert merged.measure_queue is old.measure_queue
        assert merged.measurer is measurer and merged.remeasure_top_k == 6
    empty = tmodel.ModelSet(measurer=measurer)
    empty.measure_queue = TQueue()
    assert empty.merged_with(tmodel.ModelSet()).measure_queue is \
        empty.measure_queue
