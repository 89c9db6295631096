"""The port's offline tuning loop against the JAX package's, piece by piece:
featurizer, generative sampler and workload draws, MLP (forward, training
and its npz weights), exhaustive search and the tuner end to end.

Both packages get the same numpy inputs.  Where a test needs the same
parameter space on both sides it builds the port's ``ParamSpace`` from the
reference space's params, input names and legality predicate, so the
comparison is of the algorithms, not of the TPU and Hopper legality rules.
The reference's ``SimulatedTPUBackend(noise=0)`` serves as a deterministic
label source (a test double: the port never uses it as a speed model).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import dataset as jdataset
from repro.core import features as jfeatures
from repro.core import generative as jgenerative
from repro.core import mlp as jmlp
from repro.core import search as jsearch
from repro.core import space as jspace
from repro.core import tuner as jtuner
from repro.core.backend import SimulatedTPUBackend
from repro_torch.core import dataset as tdataset
from repro_torch.core import features as tfeatures
from repro_torch.core import generative as tgenerative
from repro_torch.core import mlp as tmlp
from repro_torch.core import search as tsearch
from repro_torch.core import tuner as ttuner
from repro_torch.core.space import ParamSpace
from repro_torch.tunedb.session import backend_fingerprint
from repro_torch.tunedb.store import RecordStore


def port_space(name: str) -> ParamSpace:
    js = jspace.SPACES[name]
    return ParamSpace(name=js.name, params=dict(js.params),
                      input_params=tuple(js.input_params),
                      is_legal=js.is_legal)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small CPU matmuls run faster (and steadier) on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["gemm", "conv", "attention", "ssd"])
def test_featurizer_matches_reference(name):
    js, ts = jspace.SPACES[name], port_space(name)
    rng = np.random.default_rng(0)
    inputs = jgenerative.workload_inputs(js, 16, rng)
    cfgs = [dict(zip(js.param_names, (int(rng.choice(v)) for v in
                                      js.params.values())))
            for _ in range(64)]
    pairs = [(inputs[j % 16], c) for j, c in enumerate(cfgs)]
    jf, tf = jfeatures.Featurizer(js), tfeatures.Featurizer(ts)
    assert tf.feature_names == jf.feature_names
    xj, xt = jf.raw_batch(pairs), tf.raw_batch(pairs)
    np.testing.assert_array_equal(xt, xj)
    jf.fit(xj)
    tf.fit(xt)
    np.testing.assert_array_equal(tf.transform(xt), jf.transform(xj))
    back = tfeatures.Featurizer.from_json(ts, jf.to_json())
    np.testing.assert_array_equal(back.transform(xt), jf.transform(xj))


@pytest.mark.parametrize("name", ["gemm", "conv", "attention", "ssd"])
def test_workload_inputs_draw_like_the_reference(name):
    js = jspace.SPACES[name]
    want = jgenerative.workload_inputs(js, 200, np.random.default_rng(3))
    got = tgenerative.workload_inputs(port_space(name), 200,
                                      np.random.default_rng(3))
    assert got == want


@pytest.mark.parametrize("name", ["gemm", "conv", "attention", "ssd"])
def test_sampler_fit_and_sample_draw_like_the_reference(name):
    js, ts = jspace.SPACES[name], port_space(name)
    pool = jgenerative.workload_inputs(js, 64, np.random.default_rng(1))
    jsamp = jgenerative.CategoricalSampler(js).fit(
        pool, 1500, np.random.default_rng(2))
    tsamp = tgenerative.CategoricalSampler(ts).fit(
        pool, 1500, np.random.default_rng(2))
    for p in js.param_names:
        np.testing.assert_array_equal(tsamp.counts[p], jsamp.counts[p])
    rj, rt = np.random.default_rng(4), np.random.default_rng(4)
    assert [tsamp.sample(rt) for _ in range(100)] == \
        [jsamp.sample(rj) for _ in range(100)]
    assert tsamp.sample_legal(pool[0], rt) == jsamp.sample_legal(pool[0], rj)
    back = tgenerative.CategoricalSampler.from_json(ts, jsamp.to_json())
    for p in js.param_names:
        np.testing.assert_array_equal(back.counts[p], jsamp.counts[p])


def _jax_mlp(in_dim, hidden=(64, 128, 64), seed=0):
    return jmlp.MLP.create(jax.random.PRNGKey(seed), in_dim, hidden)


def test_mlp_forward_matches_with_weights_carried_across():
    jm = _jax_mlp(14)
    tm = tmlp.MLP.from_bytes(jm.to_bytes())
    assert tm.sizes == jm.sizes == (14, 64, 128, 64, 1)
    X = np.random.default_rng(0).normal(size=(300, 14)).astype(np.float32)
    np.testing.assert_allclose(tm.predict(X), jm.predict(X), atol=1e-5)
    # and back: the port's npz loads in the reference
    back = jmlp.MLP.from_bytes(tm.to_bytes())
    np.testing.assert_allclose(back.predict(X), jm.predict(X), atol=1e-5)


def test_mlp_fit_tracks_the_reference_from_the_same_weights():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(700, 10)).astype(np.float32)
    y = (np.sin(X[:, 0]) + X[:, 1] * X[:, 2] - np.abs(X[:, 3])
         ).astype(np.float32)
    jm = _jax_mlp(10, hidden=(32, 64, 32), seed=1)
    tm = tmlp.MLP.from_bytes(jm.to_bytes())
    hj = jm.fit(X, y, epochs=4, batch_size=128, lr=3e-3, seed=7)
    ht = tm.fit(X, y, epochs=4, batch_size=128, lr=3e-3, seed=7)
    np.testing.assert_allclose(ht, hj, rtol=1e-4, atol=1e-4)
    assert ht[-1] < ht[0]                         # it learns
    for (tw, tb), layer in zip(zip(tm.ws, tm.bs), jm.params):
        np.testing.assert_allclose(tw.detach().numpy(),
                                   np.asarray(layer["w"]), atol=1e-4)
        np.testing.assert_allclose(tb.detach().numpy(),
                                   np.asarray(layer["b"]), atol=1e-4)


def test_mlp_create_is_he_initialised_and_table2_archs_match():
    m = tmlp.MLP.create(0, 20, (512,))
    w = m.ws[0].detach().numpy()
    assert w.shape == (20, 512)
    assert abs(w.std() - np.sqrt(2.0 / 20)) < 0.02
    assert not any(float(b.detach().abs().sum()) for b in m.bs)
    assert tmlp.TABLE2_ARCHS == jmlp.TABLE2_ARCHS


def _trained_pair(name, n=600, epochs=6):
    """A JAX regressor and its port copy, over the same featurized data."""
    js, ts = jspace.SPACES[name], port_space(name)
    sim = SimulatedTPUBackend(noise=0.0)
    jds, _ = jdataset.generate_dataset(js, n, backend=sim, seed=0,
                                       n_uniform_fit=800)
    tds, _ = tdataset.generate_dataset(ts, n, backend=sim, seed=0,
                                       n_uniform_fit=800)
    assert tds.inputs == jds.inputs and tds.configs == jds.configs
    np.testing.assert_array_equal(tds.tflops, jds.tflops)
    jf, X, y = jds.featurize()
    tf, Xt, yt = tds.featurize()
    np.testing.assert_array_equal(Xt, X)
    jm = _jax_mlp(jf.dim)
    jm.fit(X, y, epochs=epochs)
    return js, ts, jm, tmlp.MLP.from_bytes(jm.to_bytes()), jf, tf


SEARCH_INPUTS = {
    "gemm": jspace.gemm_input(4, 576, 576),
    "conv": jspace.conv_input(16, 38, 166, 32, 32, 5, 10),
    "attention": {"B": 1, "Hq": 40, "Hkv": 8, "Lq": 4096, "Lkv": 4096,
                  "D": 128, "dtype_bits": 16, "causal": 1},
    "ssd": {"B": 1, "L": 2048, "H": 64, "P": 64, "S": 128, "dtype_bits": 16},
}


@pytest.mark.parametrize("name", ["gemm", "conv", "attention", "ssd"])
def test_exhaustive_search_ranks_like_the_reference(name):
    js, ts, jm, tm, jf, tf = _trained_pair(name)
    inputs = SEARCH_INPUTS[name]
    jr = jsearch.exhaustive_search(js, inputs, model=jm, featurizer=jf,
                                   top_k=8)
    tr = tsearch.exhaustive_search(ts, inputs, model=tm, featurizer=tf,
                                   top_k=8)
    assert tr.n_candidates == jr.n_candidates
    assert [c for c, _ in tr.top_k] == [c for c, _ in jr.top_k]
    np.testing.assert_allclose([p for _, p in tr.top_k],
                               [p for _, p in jr.top_k], rtol=1e-4)
    # with re-measurement both keep the measured argmax of the same top-k
    sim = SimulatedTPUBackend(noise=0.0)
    measure = lambda c: sim.measure(name, c, inputs)
    jr = jsearch.exhaustive_search(js, inputs, model=jm, featurizer=jf,
                                   top_k=8, measure=measure)
    tr = tsearch.exhaustive_search(ts, inputs, model=tm, featurizer=tf,
                                   top_k=8, measure=measure)
    assert tr.best == jr.best and tr.measured == jr.measured
    assert tsearch.oracle_search(ts, inputs, measure) == \
        jsearch.oracle_search(js, inputs, measure)


def test_enumerate_legal_matches_the_reference():
    inputs = jspace.gemm_input(96, 200, 512)
    assert tsearch.enumerate_legal(port_space("gemm"), inputs) == \
        jsearch.enumerate_legal(jspace.GEMM_SPACE, inputs)
    assert tsearch.enumerate_legal(port_space("gemm"), inputs, cap=5) == \
        jsearch.enumerate_legal(jspace.GEMM_SPACE, inputs, cap=5)


def test_tuner_picks_the_reference_tuners_config(tmp_path, monkeypatch):
    """train + best_config on the same labels pick the same config for
    every shape.  The one step the packages cannot share is the initial
    weights (``jax.random`` and ``torch.Generator`` draw different numbers
    from one seed), so the port's ``MLP.create`` starts here from the JAX
    draw; everything after it — sampler, dataset, featurizer, training,
    search, re-measurement — is the port's own."""
    def create_from_jax(cls, seed, in_dim, hidden=(64, 128, 64)):
        return cls.from_bytes(_jax_mlp(in_dim, tuple(hidden), seed).to_bytes())
    monkeypatch.setattr(tmlp.MLP, "create", classmethod(create_from_jax))
    sim = SimulatedTPUBackend(noise=0.0)
    js, ts = jspace.GEMM_SPACE, port_space("gemm")
    jt = jtuner.InputAwareTuner.train(js, n_samples=2000, epochs=10,
                                      backend=sim, seed=0)
    tt = ttuner.InputAwareTuner.train(ts, n_samples=2000, epochs=10,
                                      backend=sim, seed=0)
    shapes = [jspace.gemm_input(*s) for s in
              ((4, 576, 576), (32, 1536, 576), (2048, 2048, 2048),
               (512, 16, 4096), (64, 64, 65536))]
    for inputs in shapes:
        assert tt.best_config(inputs) == jt.best_config(inputs), inputs
    # the port's tuner commits its picks under the port's fingerprint
    store = RecordStore(tmp_path / "t.jsonl")
    tt.store = store
    tt._mem_cache.clear()
    cfg = tt.best_config(shapes[0])
    rec = store.get("gemm", shapes[0], backend=backend_fingerprint(sim))
    assert rec is not None and rec.config == cfg
    assert rec.backend.startswith("repro.SimulatedTPUBackend")


def test_tuner_save_load_round_trip(tmp_path):
    sim = SimulatedTPUBackend(noise=0.0)
    ts = port_space("gemm")
    tt = ttuner.InputAwareTuner.train(ts, n_samples=300, epochs=2,
                                      backend=sim, seed=0)
    tt.save(str(tmp_path))
    back = ttuner.InputAwareTuner.load(str(tmp_path), ts, backend=sim)
    inputs = jspace.gemm_input(32, 576, 1536)
    assert back.search(inputs, remeasure=False).best == \
        tt.search(inputs, remeasure=False).best
    # a JAX tuner's saved directory loads in the port, and vice versa
    jt = jtuner.InputAwareTuner.load(str(tmp_path), jspace.GEMM_SPACE,
                                     backend=sim)
    assert jt.search(inputs, remeasure=False).best == \
        back.search(inputs, remeasure=False).best


def test_installed_tuner_answers_dispatch():
    from repro_torch.kernels import dispatch as tdispatch
    sim = SimulatedTPUBackend(noise=0.0)
    tt = ttuner.InputAwareTuner.train(port_space("gemm"), n_samples=200,
                                      epochs=1, backend=sim, seed=0)
    inputs = jspace.gemm_input(8, 256, 256)
    tt._mem_cache[ttuner.input_key("gemm", inputs)] = {"bm": 16}
    ttuner.install_tuner(tt)
    try:
        assert ttuner.get_tuner("gemm") is tt
        assert tdispatch._resolve_cfg("gemm", inputs) == ({"bm": 16}, "tuner")
    finally:
        ttuner.clear_tuners()
    assert ttuner.get_tuner("gemm") is None


@pytest.mark.parametrize("name,inputs", [
    ("attention", {"B": 4, "Hq": 9, "Hkv": 3, "Lq": 1, "Lkv": 256, "D": 64,
                   "dtype_bits": 16, "causal": 1}),
    ("ssd", {"B": 1, "L": 2048, "H": 64, "P": 64, "S": 128,
             "dtype_bits": 16}),
])
def test_tuner_loop_for_attention_and_ssd_on_the_cpu(name, inputs, tmp_path):
    """The port's own loop over the port's Hopper spaces: labels from the
    gate and the plain versions timed on a shrunken CPU instance, then a
    pick (re-measured) that the space calls legal, committed to the store
    under the CPU fingerprint."""
    from repro_torch.core.backend import CheckedBackend, CudaEventBackend
    from repro_torch.core.space import SPACES
    space = SPACES[name]
    backend = CheckedBackend(CudaEventBackend(device="cpu"))
    store = RecordStore(tmp_path / "t.jsonl")
    tt = ttuner.InputAwareTuner.train(space, n_samples=24, epochs=2,
                                      hidden=(16, 16), backend=backend,
                                      seed=0, store=store)
    tt.top_k = 3
    cfg = tt.best_config(inputs)
    assert space.is_legal(cfg, inputs)
    rec = store.get(name, inputs, backend=backend_fingerprint(backend))
    assert rec is not None and rec.config == cfg and rec.tflops > 0
    assert "device=cpu" in rec.backend
