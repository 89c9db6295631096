"""The port's collective accounting and roofline (``repro_torch.analysis``)
against the reference's (``repro.analysis``).

One module fixture starts four ``gloo`` ranks, which record the
collectives of the expert-parallel paths (meshes (1, 4) and (2, 2), fp32
and bf16), of dbrx-132b's SMOKE prefill under each mesh path and of the
gpipe pipeline, and beside them one JAX child, which compiles the same
programs on 4 host devices and counts their HLO's collectives with the
reference's ``collective_bytes``.

Where the two counts differ, the test states why and asserts the rule:
  * the reference splits the batch over ``data`` and the port does not
    (its ranks hold the whole batch), so at (2, 2) the port's EP buffers
    are ``data`` times the reference's, and where the program ends
    replicated XLA adds the output's all-gather over ``data``;
  * XLA gathers the a2a output over ``model`` and ``data`` in two steps;
  * the HLO of the pipeline's loop holds its ``collective-permute`` once,
    so the reference counts one tick of the ring, the port every tick;
  * XLA:CPU sends bf16 collectives as f32 (the reference's
    ``normalize_bits`` undoes it), the port sends bf16.
"""

import json
import math

import pytest

from repro.analysis import roofline as jroofline
from repro.configs import SHAPES as JSHAPES
from repro.configs import registry as jregistry
from repro_torch.analysis import comm, roofline
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, smoke_config
from repro_torch.core.backend import H100_SXM

from torch_ranks import finish, load_ranks, start_child, start_ranks

E, K, D, F, B, S = 8, 2, 32, 64, 2, 16
MESHES = ((1, 4), (2, 2))
PATHS = ("moe_ep", "moe_ep_a2a")
DTYPES = ("float32", "bfloat16")
N_STAGES, N_MICRO, MICRO = 4, 6, (4, 16)
CELLS = [(a, s) for a in sorted(ARCH_NAMES) for s in SHAPES]

RANKS = r"""
import dataclasses
import numpy as np
from repro_torch.analysis import comm
from repro_torch.compat import make_mesh
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_cache, init_params, prefill
from repro_torch.models import moe as TM
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import pipeline_apply, stage_split

gen = torch.Generator().manual_seed(0)
p32 = TM.init_moe(gen, 32, 64, 8, torch.float32)
x32 = torch.randn(2, 16, 32, generator=gen)
cfg0 = smoke_config("dbrx-132b")
params = init_params(cfg0, gen)
toks = torch.randint(0, cfg0.vocab, (4, 8), generator=gen)
for model in (4, 2, 1):
    mesh = make_host_mesh(model, device="cpu")
    tag = f"{WORLD // model}x{model}"
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        p = {k: (v if k == "router" else v.to(dtype)) for k, v in p32.items()}
        for name in ("moe_ep", "moe_ep_a2a"):
            with torch.no_grad(), comm.record() as ops:
                getattr(TM, name)(p, x32.to(dtype), n_experts=8, top_k=2,
                                  capacity_factor=8.0, mesh=mesh)
            RESULTS[f"{tag}/{name}/{dt}"] = comm.collective_bytes(ops)
    for a2a in (False, True):
        cfg = dataclasses.replace(cfg0, moe_a2a=a2a)
        with torch.no_grad(), shd.use_rules(mesh), comm.record() as ops:
            prefill(shd.expert_slabs(params, mesh), cfg, {"tokens": toks},
                    init_cache(cfg, 4, 8, torch.device("cpu")))
        RESULTS[f"{tag}/prefill/{a2a}"] = comm.collective_bytes(ops)

ws = torch.randn(8, 16, 16, generator=gen) * 0.2
x = torch.randn(6, 4, 16, generator=gen)
stage_mesh = make_mesh((WORLD,), ("stage",), "cpu")
with comm.record() as outer:
    with comm.record() as ops:
        pipeline_apply(lambda w, h: torch.tanh(h @ w[0]) @ w[1],
                       stage_split(ws, WORLD), x, mesh=stage_mesh)
RESULTS["pipeline"] = comm.collective_bytes(ops)
RESULTS["pipeline_ops"] = [(o.kind, o.dtype, o.shape) for o in ops]
RESULTS["nested"] = len(outer) == len(ops)
"""

JAX = r"""
import json, os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.analysis.hlo import collective_bytes
from repro.compat import auto_axis_types, make_mesh
from repro.models import moe as JM
from repro.parallel.pipeline import pipeline_apply, stage_split

progs = {}
for shape in ((1, 4), (2, 2)):
    mesh = make_mesh(shape, ("data", "model"), axis_types=auto_axis_types(2))
    rep = NamedSharding(mesh, P())
    for dt in ("float32", "bfloat16"):
        p = JM.init_moe(jax.random.PRNGKey(0), 32, 64, 8, getattr(jnp, dt))
        x = jnp.zeros((2, 16, 32), getattr(jnp, dt))
        for name in ("moe_ep", "moe_ep_a2a"):
            fn = lambda p, x, f=getattr(JM, name), mesh=mesh: f(
                p, x, n_experts=8, top_k=2, capacity_factor=8.0, mesh=mesh)
            # the port's paths end with the output on every rank
            progs[f"{shape[0]}x{shape[1]}/{name}/{dt}"] = jax.jit(
                fn, out_shardings=(rep, rep)).lower(p, x)
stages = Mesh(np.array(jax.devices()[:4]), ("stage",))
progs["pipeline"] = jax.jit(lambda w, x: pipeline_apply(
    lambda w, h: jnp.tanh(h @ w[0]) @ w[1], stage_split(w, 4), x,
    mesh=stages)).lower(jnp.zeros((8, 16, 16)), jnp.zeros((6, 4, 16)))
with ThreadPoolExecutor(4) as pool:
    texts = dict(zip(progs, pool.map(lambda l: l.compile().as_text(),
                                     progs.values())))
out = {k: {"raw": collective_bytes(t),
           "bf16": collective_bytes(t, normalize_bits=16)}
       for k, t in texts.items()}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("analysis")
    procs = start_ranks(RANKS, 4, tmp)
    procs.append(start_child(JAX, tmp, "jax", [str(tmp / "jax.json")]))
    finish(procs)
    return {"ranks": load_ranks(tmp, 4),
            "ref": json.loads((tmp / "jax.json").read_text())}


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _formula(path, shape, dtype):
    return comm.moe_bytes(path, B=B, S=S, D=D, n_experts=E, top_k=K,
                          capacity_factor=8.0, tp=shape[1],
                          itemsize=2 if dtype == "bfloat16" else 4)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES + ((4, 1),), ids=_tag)
def test_ep_bytes_equal_the_formula(runs, shape, path, dtype):
    want = _formula(path, shape, dtype)
    for r in runs["ranks"]:
        assert r[f"{_tag(shape)}/{path}/{dtype}"] == want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_ep_bytes_against_the_reference_hlo(runs, shape, path, dtype):
    got = runs["ranks"][0][f"{_tag(shape)}/{path}/{dtype}"]
    ref = runs["ref"][f"{_tag(shape)}/{path}/{dtype}"]
    # XLA:CPU sends bf16 as f32; the aux loss's all-reduce is f32 in both
    want = dict(ref["bf16" if dtype == "bfloat16" else "raw"])
    want["all-reduce"] = (ref["raw"]["all-reduce"] if path == "moe_ep_a2a"
                          else want["all-reduce"])
    dp, act = shape[0], got["all-reduce"] if path == "moe_ep" \
        else got["all-gather"]
    assert got["all-to-all"] == dp * want["all-to-all"]
    if path == "moe_ep":
        assert got["all-reduce"] == dp * want["all-reduce"]
        # XLA gathers the batch shards over data; the port holds them
        assert want["all-gather"] == (act if dp > 1 else 0)
        assert got["all-gather"] == 0
    else:
        assert got["all-reduce"] == want["all-reduce"] == 4
        # XLA gathers the output over model, then over data
        assert want["all-gather"] == act // dp + (act if dp > 1 else 0)
    if dp == 1:
        assert all(got[k] == want[k] for k in comm.COLLECTIVE_KINDS)
    for kind in ("reduce-scatter", "collective-permute"):
        assert got[kind] == want[kind] == 0


@pytest.mark.parametrize("a2a", [False, True])
@pytest.mark.parametrize("shape", MESHES + ((4, 1),), ids=_tag)
def test_model_prefill_bytes_are_the_layers_formula(runs, shape, a2a):
    """dbrx SMOKE's prefill under each mesh: its MoE layers' formula, once
    a layer; nothing else in the model communicates."""
    cfg = smoke_config("dbrx-132b")
    one = comm.moe_bytes("moe_ep_a2a" if a2a else "moe_ep", B=4, S=8,
                         D=cfg.d_model, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, tp=shape[1],
                         itemsize=4)
    want = {k: cfg.n_layers * v for k, v in one.items()}
    for r in runs["ranks"]:
        assert r[f"{_tag(shape)}/prefill/{a2a}"] == want


def test_pipeline_bytes_equal_the_formula_and_the_reference(runs):
    micro = math.prod(MICRO) * 4
    want = comm.pipeline_bytes(n_micro=N_MICRO, n_stages=N_STAGES,
                               micro_bytes=micro)
    ref = runs["ref"]["pipeline"]["raw"]
    for r in runs["ranks"]:
        assert r["pipeline"] == want
        assert r["nested"]
        kinds = [k for k, *_ in r["pipeline_ops"]]
        assert kinds == ["collective-permute"] * (N_MICRO + N_STAGES - 1) \
            + ["all-reduce"]
        assert all(dt == "f32" for _, dt, _ in r["pipeline_ops"])
    assert ref["all-reduce"] == want["all-reduce"]
    # the loop body's one permute, counted once in the HLO
    assert ref["collective-permute"] * (N_MICRO + N_STAGES - 1) \
        == want["collective-permute"]
    assert comm.pipeline_bytes(n_micro=4, n_stages=1, micro_bytes=10) == {
        **{k: 0 for k in comm.COLLECTIVE_KINDS}, "all-reduce": 40,
        "total": 40}


def test_record_nests_and_note_checks_the_kind():
    import torch
    assert comm.COLLECTIVE_KINDS == (
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")
    comm.note("all-reduce", torch.zeros(3))          # nothing records
    with comm.record() as outer:
        comm.note("all-gather", torch.zeros(2, 3, dtype=torch.bfloat16))
        with comm.record() as inner:
            comm.note("all-to-all", torch.zeros(4, dtype=torch.int32))
    assert [o.kind for o in outer] == ["all-gather", "all-to-all"]
    assert [(o.dtype, o.shape, o.bytes) for o in inner] == [("s32", (4,),
                                                              16)]
    assert comm.collective_bytes(outer)["total"] == 12 + 16
    with pytest.raises(ValueError):
        comm.note("broadcast", torch.zeros(1))
    assert comm.collective_bytes([]) == {
        **{k: 0 for k in comm.COLLECTIVE_KINDS}, "total": 0}


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_reference(arch, shape):
    kind = SHAPES[shape].kind
    got = roofline.model_flops(get_config(arch), SHAPES[shape], kind=kind)
    want = jroofline.model_flops(jregistry.get_config(arch), JSHAPES[shape],
                                 kind=kind)
    assert got == want


def _artifact(**kw):
    art = {"arch": "smollm-135m", "shape": "train_4k", "kind": "train",
           "mesh": "16x16", "chips": 256, "model_flops": 1.0,
           "cost": {"flops": 989e12, "bytes_accessed": 2 * 3.35e12},
           "collectives": {"total": 0.5 * 450e9}}
    art.update(kw)
    return art


def test_roofline_terms_use_the_h100_peaks():
    assert roofline.PEAK_FLOPS_BF16 == H100_SXM.bf16_tflops * 1e12 == 989e12
    assert roofline.HBM_BW == H100_SXM.hbm_gbps * 1e9 == 3.35e12
    assert roofline.NVLINK_BW == 450e9
    rt = roofline.roofline_from_artifacts(_artifact(),
                                          recompute_model_flops=False)
    assert rt.t_compute == pytest.approx(1.0)
    assert rt.t_memory == pytest.approx(2.0)       # bytes not halved
    assert rt.t_collective == pytest.approx(0.5)
    assert rt.bottleneck == "memory"
    assert rt.useful_ratio == pytest.approx(1.0 / (989e12 * 256))
    assert rt.roofline_fraction == pytest.approx(1.0 / 256 / 989e12 / 2.0)
    # the reference's terms on the same artifact are a v5e's
    jt = jroofline.roofline_from_artifacts(_artifact(),
                                           recompute_model_flops=False)
    assert jt.t_compute == pytest.approx(989e12 / 197e12)


def test_roofline_recomputes_model_flops_and_formats():
    rt = roofline.roofline_from_artifacts(_artifact())
    assert rt.model_flops_global == roofline.model_flops(
        get_config("smollm-135m"), SHAPES["train_4k"], kind="train")
    assert rt.to_dict()["bottleneck"] == "memory"
    table = roofline.format_table([rt], title="t")
    assert table.splitlines()[0] == "### t"
    assert "| smollm-135m | train_4k | 16x16 | 1000.00 ms " in table
    assert roofline.HW["nvlink_bw"] == 450e9
