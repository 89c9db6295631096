"""The port stands alone: importing it (and chip_smoke.py) loads neither JAX
nor the JAX package, and its entry points default to the GPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.configs import smollm_135m as tconfigs
from repro_torch.configs.shapes import make_batch
from repro_torch.kernels import attention as kattention
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd as kssd
from repro_torch.models import init_params
from repro_torch.serve import Engine, ServeConfig

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    r = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["bad"] == []
    assert {"repro_torch.kernels.matmul", "repro_torch.kernels.attention",
            "repro_torch.kernels.ssd", "repro_torch.serve.engine",
            "repro_torch.tunedb.store", "repro_torch.tunedb.telemetry",
            "repro_torch.tunedb.plans", "repro_torch.tunedb.measure",
            "repro_torch.weights", "repro_torch.models.ssm",
            "repro_torch.models.placed", "repro_torch.parallel.sharding",
            "repro_torch.parallel.collectives",
            "repro_torch.configs.mamba2_1p3b",
            "repro_torch.configs.qwen3_14b", "repro_torch.configs.glm4_9b",
            "repro_torch.configs.llama3_405b", "repro_torch.models.moe",
            "repro_torch.configs.arctic_480b", "repro_torch.configs.dbrx_132b",
            "repro_torch.configs.jamba_v01_52b",
            "repro_torch.configs.whisper_base",
            "repro_torch.configs.internvl2_76b",
            "repro_torch.tunedb.controller", "repro_torch.tunedb.obs",
            "repro_torch.tunedb.obs.metrics",
            "repro_torch.tunedb.obs.sentry", "repro_torch.tunedb.obs.trace",
            "repro_torch.tunedb.obs.snapshot",
            "repro_torch.tunedb.obs.server", "repro_torch.tunedb.session",
            "repro_torch.tunedb.__main__",
            "repro_torch.tunedb.fleet", "repro_torch.tunedb.fleet.lease",
            "repro_torch.tunedb.fleet.worker",
            "repro_torch.tunedb.fleet.coordinator",
            "repro_torch.serve.router", "repro_torch.tunedb.chaos",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.optim", "repro_torch.optim.adamw",
            "repro_torch.optim.compress", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.train",
            "repro_torch.train.checkpoint", "repro_torch.train.fault",
            "repro_torch.train.trainer", "repro_torch.compat",
            "repro_torch.launch.mesh", "repro_torch.parallel",
            "repro_torch.parallel.sharding", "repro_torch.parallel.pipeline",
            "repro_torch.parallel.collectives", "repro_torch.analysis",
            "repro_torch.analysis.comm", "repro_torch.analysis.roofline",
            "repro_torch.configs.shapes",
            "repro_torch.launch.dryrun"} <= set(out["modules"])


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device()
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = init_params(tconfigs.SMOKE, gen)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(tconfigs.SMOKE, params, ServeConfig(max_len=16, slots=1))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke", "--requests", "1", "--max-new", "1"])


def test_meshes_and_the_parallel_phase_name_no_cpu_default(no_cuda):
    """``make_host_mesh()`` and ``make_production_mesh()`` with no device
    want CUDA before they touch ``torch.distributed``; chip_smoke's
    parallel phase builds its group on NCCL and its mesh on the card,
    with no gloo, fake or CPU fallback."""
    import inspect
    import sys as _sys
    from repro_torch.launch import mesh as lmesh
    with pytest.raises(RuntimeError, match="CUDA"):
        lmesh.make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        lmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_batch(tconfigs.SMOKE, "train_4k")
    for sig in (inspect.signature(lmesh.make_host_mesh),
                inspect.signature(lmesh.make_production_mesh),
                inspect.signature(make_batch)):
        assert sig.parameters["device"].default is None
    _sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        _sys.path.remove(str(REPO))
    src = inspect.getsource(chip_smoke.phase_parallel) + inspect.getsource(
        chip_smoke.parallel_checks)
    assert '"nccl"' in src and "make_host_mesh(model=1, device=dev)" in src
    for word in ('"cpu"', "gloo", '"fake"', "init_fake_world"):
        assert word not in src, word


def test_gemm_never_takes_the_plain_version_off_the_cpu(monkeypatch):
    """Only a CPU tensor reaches matmul_plain / splitk_reduce_plain; a
    CUDA tensor launches the kernel or raises, and a meta tensor (the
    dry-run's) gets a meta result of the kernel's shape: no plain
    version, no launch."""
    def boom(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")
    monkeypatch.setattr(kmatmul, "matmul_plain", boom)
    monkeypatch.setattr(kmatmul, "splitk_reduce_plain", boom)
    a = torch.empty((4, 64), dtype=torch.bfloat16, device="meta")
    b = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    before = (kmatmul.launches, kmatmul.reduce_launches)
    for ks in (1, 2):
        c = tops.matmul(a, b, {"bm": 16, "bn": 32, "bk": 32, "k_split": ks})
        assert c.device.type == "meta" and c.shape == (4, 32)
    assert (kmatmul.launches, kmatmul.reduce_launches) == before


def test_attention_and_ssd_have_no_fallback_off_the_cpu(monkeypatch):
    """Only a CPU tensor reaches attention_plain / ssd_plain; SDPA is never
    called; any other device launches the kernel or raises (here: the meta
    device, which has no kernel)."""
    def boom(*a, **k):
        raise AssertionError("plain version or SDPA called off the CPU")
    monkeypatch.setattr(kattention, "attention_plain", boom)
    monkeypatch.setattr(kssd, "ssd_plain", boom)
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention",
                        boom)
    meta = lambda *s: torch.empty(s, dtype=torch.bfloat16, device="meta")
    a0, s0 = kattention.launches, kssd.launches
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention(meta(1, 4, 1, 64), meta(1, 2, 40, 64),
                             meta(1, 2, 40, 64), q_offset=39)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.ssd_scan(meta(1, 40, 4, 64), meta(1, 40, 4),
                      torch.empty(4, device="meta"), meta(1, 40, 128),
                      meta(1, 40, 128))
    assert (kattention.launches, kssd.launches) == (a0, s0)
