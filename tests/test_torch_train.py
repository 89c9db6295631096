"""The port's trainer against the reference's: 3 steps of ``Trainer`` on
SmolLM SMOKE (fp32) from the same params, microbatches 1 and 2,
compression off and on (the loss history within 1e-4 relative, the final
params within PARAM_TOL); a reference checkpoint resumed by the port; a
port checkpoint loaded by the reference; a reference state carried across
by ``train_state_from_jax``; checkpoint gc, ``latest_step`` and async
saves; the straggler monitor and the preemption flag; the launcher."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import DataConfig as JDataConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import Trainer as JTrainer
from repro.train import TrainConfig as JTrainConfig
from repro.train import load_checkpoint as jload_checkpoint
from repro.train import save_checkpoint as jsave_checkpoint
from repro.train.trainer import init_train_state as jinit_train_state
from repro.train.trainer import make_train_step as jmake_train_step
from repro_torch.configs import smoke_config
from repro_torch.data import DataConfig
from repro_torch.models import tree_leaves
from repro_torch.optim import AdamWConfig, AdamWState
from repro_torch.train import (PreemptionHandler, StragglerMonitor,
                               TrainConfig, Trainer, latest_step,
                               load_checkpoint, save_checkpoint)
from repro_torch.train.trainer import init_train_state, make_train_step
from repro_torch.weights import train_state_from_jax

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
PARAM_TOL = 1e-4            # max |p - p_ref| after 3 steps at lr 1e-3
# with compression a quantised gradient element that rounds the other way
# moves its parameter by up to lr a step under Adam's normalised update:
# every element within 3 x lr, all but 1 in 1e3 within PARAM_TOL
PARAM_TOL_INT8 = 3e-3
ARCH = "smollm-135m"
DATA = dict(seq_len=32, global_batch=4)
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread runs them as fast
    as eight, and leaves the cores to the suite's other workers, whose
    timing tests feel a spinning thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_trainer(steps, **tc):
    jcfg = jregistry.smoke_config(ARCH)
    return JTrainer(jcfg, JAdamWConfig(**OPT), JTrainConfig(
        steps=steps, log_every=100, **tc), JDataConfig(vocab=jcfg.vocab,
                                                       **DATA))


def _port_trainer(steps, ck, **tc):
    tcfg = smoke_config(ARCH)
    return Trainer(tcfg, AdamWConfig(**OPT), TrainConfig(
        steps=steps, log_every=100, checkpoint_dir=ck, **tc),
        DataConfig(vocab=tcfg.vocab, **DATA), device="cpu")


def _both(steps, ck, **tc):
    """The reference's trainer, and the port's on ``ck`` holding the
    reference's initial state as a step-0 checkpoint, which the port's
    auto-resume loads: both start from the same parameters."""
    jcfg = jregistry.smoke_config(ARCH)
    js = jinit_train_state(jcfg, JAdamWConfig(**OPT), JTrainConfig(**tc),
                           jax.random.PRNGKey(0))
    jsave_checkpoint(ck, 0, jax.tree_util.tree_map(np.asarray, js))
    return _ref_trainer(steps, **tc), _port_trainer(steps, ck, **tc)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy()
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _losses(res):
    return [h["loss"] for h in res["history"]]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("nm", [1, 2])
def test_three_steps_equal_the_reference(nm, compress, tmp_path):
    jt, tt = _both(3, str(tmp_path), microbatches=nm,
                   compress_grads=compress)
    jres, tres = jt.run(verbose=False), tt.run(verbose=False)
    np.testing.assert_allclose(_losses(tres), _losses(jres), rtol=LOSS_RTOL)
    assert _losses(tres)[-1] < _losses(tres)[0]
    jp, tp = _paths(jres["state"]["params"]), _paths(tres["state"]["params"])
    assert set(jp) == set(tp)
    for k in jp:
        err = np.abs(tp[k] - jp[k])
        if compress:
            assert err.max() <= PARAM_TOL_INT8, (k, err.max())
            assert (err > PARAM_TOL).mean() <= 1e-3, k
        else:
            assert err.max() <= PARAM_TOL, (k, err.max())
    assert tres["state"]["opt"].step == int(jres["state"]["opt"].step) == 3
    if compress:
        je, te = _paths(jres["state"]["ef"]), _paths(tres["state"]["ef"])
        for k in je:
            # an element whose quantisation rounds the other way differs by
            # one scale step; the rest agree
            err = np.abs(te[k] - je[k])
            assert (err > 1e-2 * np.abs(je[k]).max()).mean() <= 1e-2, k


def test_port_resumes_a_reference_checkpoint(tmp_path):
    """The reference writes its exit snapshot at step 2; the port resumes
    there and its step 2 (the third) has the reference's uninterrupted
    loss."""
    want = _losses(_ref_trainer(3).run(verbose=False))
    ck = str(tmp_path / "ck")
    _ref_trainer(2, checkpoint_dir=ck).run(verbose=False)
    assert latest_step(ck) == 2
    state, start = _port_trainer(3, ck).init_or_resume()
    assert start == 2 and state["opt"].step == 2
    assert all(t.requires_grad for t in tree_leaves(state["params"]))
    res = _port_trainer(3, ck).run(verbose=False)
    assert [h["step"] for h in res["history"]] == [2]
    assert res["history"][0]["loss"] == pytest.approx(want[2], rel=LOSS_RTOL)


def test_reference_loads_a_port_checkpoint(tmp_path):
    jcfg, tcfg = jregistry.smoke_config(ARCH), smoke_config(ARCH)
    tc = TrainConfig(compress_grads=True)
    state = init_train_state(tcfg, AdamWConfig(), tc, "cpu")
    state["opt"] = AdamWState(step=5, m=state["opt"].m, v=state["opt"].v)
    save_checkpoint(str(tmp_path), 5, state, data_step=5)
    key = jax.random.PRNGKey(0)
    template = jax.eval_shape(lambda: jinit_train_state(
        jcfg, JAdamWConfig(), JTrainConfig(compress_grads=True), key))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      template)
    got, step, dstep = jload_checkpoint(str(tmp_path), template)
    assert (step, dstep) == (5, 5) and int(got["opt"].step) == 5
    np.testing.assert_array_equal(got["rng"], [0, 1])
    want = _paths(state["params"])
    for k, v in _paths(got["params"]).items():
        np.testing.assert_array_equal(v, want[k])


def test_bf16_leaves_are_stored_as_the_reference_stores_them(tmp_path):
    """2-byte V2 words in the npz, "bfloat16" in the manifest; read back
    bitwise."""
    t = torch.randn(3, 5).to(torch.bfloat16)
    state = {"params": {"w": t}, "rng": np.array([0, 1], np.uint32)}
    save_checkpoint(str(tmp_path), 1, state)
    man = json.loads((tmp_path / "step-1" / "manifest.json").read_text())
    assert man["keys"]["params/w"]["dtype"] == "bfloat16"
    with np.load(tmp_path / "step-1" / "arrays.npz") as z:
        assert z["params/w"].dtype == np.dtype("V2")
    got, _, _ = load_checkpoint(str(tmp_path), {
        "params": {"w": torch.zeros(3, 5, dtype=torch.bfloat16)},
        "rng": np.zeros(2, np.uint32)})
    assert torch.equal(got["params"]["w"], t)
    with pytest.raises(TypeError, match="dtype"):
        load_checkpoint(str(tmp_path), {"params": {"w": torch.zeros(3, 5)},
                                        "rng": np.zeros(2, np.uint32)})


def test_a_reference_state_carries_across():
    """``train_state_from_jax`` of the reference's state after one step;
    the next step in both packages gives the same loss."""
    jcfg, tcfg = jregistry.smoke_config(ARCH), smoke_config(ARCH)
    jtc = JTrainConfig(compress_grads=True)
    jstep = jmake_train_step(jcfg, JAdamWConfig(**OPT), jtc)
    pipe_kw = dict(vocab=jcfg.vocab, **DATA)
    from repro.data import SyntheticTokenPipeline as JPipe
    pipe = JPipe(JDataConfig(**pipe_kw))
    js = jinit_train_state(jcfg, JAdamWConfig(**OPT), jtc,
                           jax.random.PRNGKey(0))
    js, _ = jstep(js, {"tokens": jnp.asarray(pipe.batch(0)["tokens"])})
    ts = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), tcfg,
                              "cpu")
    assert ts["opt"].step == 1 and set(ts) == {"params", "opt", "rng", "ef"}
    assert all(t.requires_grad for t in tree_leaves(ts["params"]))
    b1 = pipe.batch(1)["tokens"]
    js, jm = jstep(js, {"tokens": jnp.asarray(b1)})
    tstep = make_train_step(tcfg, AdamWConfig(**OPT),
                            TrainConfig(compress_grads=True))
    ts, tm = tstep(ts, {"tokens": torch.from_numpy(b1).long()})
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    assert float(tm["ef_norm"]) == pytest.approx(float(jm["ef_norm"]),
                                                 rel=1e-2)


def test_stochastic_rounding_step_moves_the_key_and_bf16_params():
    """With ``stochastic_rounding`` each step derives a new key from the
    state's two words and rounds the bf16 parameters with it; the same
    key gives the same step."""
    import dataclasses
    cfg = dataclasses.replace(smoke_config(ARCH), dtype=torch.bfloat16)
    tc = TrainConfig(stochastic_rounding=True)
    step = make_train_step(cfg, AdamWConfig(**OPT), tc)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16),
                                     generator=torch.Generator().manual_seed(0))}
    out = []
    for _ in range(2):
        state = init_train_state(cfg, AdamWConfig(**OPT), tc, "cpu")
        before = [t.detach().clone() for t in tree_leaves(state["params"])]
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
        assert not np.array_equal(state["rng"], [0, 1])
        assert any(not torch.equal(a, b) for a, b in
                   zip(before, tree_leaves(state["params"])))
        out.append((state["rng"], [t.detach().clone()
                                   for t in tree_leaves(state["params"])]))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_latest_step_and_gc(tmp_path):
    s = {"params": {"w": torch.ones(2, 2)}}
    assert latest_step(str(tmp_path / "none")) is None
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), step, s, keep=3)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(int(p.name.split("-")[1])
                  for p in tmp_path.glob("step-*")) == [3, 4, 5]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), s)


def test_async_save_copies_before_the_thread(tmp_path):
    w = torch.ones(4, 4)
    t = save_checkpoint(str(tmp_path), 7, {"params": {"w": w}},
                        async_save=True)
    w.add_(1)                         # training goes on changing it
    t.join()
    assert latest_step(str(tmp_path)) == 7
    got, _, _ = load_checkpoint(str(tmp_path), {"params": {"w": w}})
    assert bool((got["params"]["w"] == 1).all())


def test_trainer_checkpoints_and_resumes(tmp_path):
    mk = lambda steps: Trainer(
        smoke_config(ARCH), AdamWConfig(lr=1e-3, warmup_steps=2,
                                        total_steps=40),
        TrainConfig(steps=steps, microbatches=2, compress_grads=True,
                    checkpoint_every=2, checkpoint_dir=str(tmp_path),
                    log_every=100),
        DataConfig(vocab=512, **DATA), device="cpu")
    res = mk(5).run(verbose=False)
    assert len(res["history"]) == 5
    assert latest_step(str(tmp_path)) == 5
    res2 = mk(7).run(verbose=False)
    assert [h["step"] for h in res2["history"]] == [5, 6]


def test_trainer_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(smoke_config(ARCH), AdamWConfig(), TrainConfig(),
                DataConfig(vocab=512, **DATA))


def test_straggler_detection():
    mon = StragglerMonitor(threshold=3.0, grace_steps=2)
    events = []
    mon.on_straggler = lambda s, dt, base: events.append(s)
    for i in range(5):
        mon.step_start()
        time.sleep(0.01)
        mon.step_end(i)
    mon.step_start()
    time.sleep(0.08)
    mon.step_end(5)
    assert events == [5]
    mon.step_start()
    time.sleep(0.01)
    mon.step_end(6)
    assert events == [5]


def test_preemption_flag():
    h = PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_stop
    signal.raise_signal(signal.SIGUSR1)
    assert h.should_stop
    h.restore()


def test_launcher_trains_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--steps", "2"], capture_output=True,
        text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "final loss" in r.stdout


def test_launcher_refuses_a_large_config_on_the_cpu():
    from repro_torch.launch import train as launch_train
    with pytest.raises(SystemExit, match="--smoke"):
        launch_train.main(["--arch", "dbrx-132b", "--device", "cpu"])
