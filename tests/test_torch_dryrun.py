"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

Its counts are held to a real run of the same step: every SMOKE config's
train, prefill and decode step at a tiny shape on meta tensors against
the same step on CPU tensors (plain versions, the GEMM wrapper counted as
one op), against the same meta step with no op replayed, and against
``torch.utils.flop_counter.FlopCounterMode`` with the GEMM as one
``torch.mm``.  A split-K GEMM's bytes and the MoE mesh
paths' collective bytes are held to their formulas, the full CONFIGs'
argument bytes to the parameter, AdamW-state and accumulator formula.
The reference's policies, skip reasons and artifact names come from a
JAX child (``repro.launch.dryrun`` sets 512 host devices for its whole
process, so it is never imported here); the collectives and the full
CONFIGs' parameter trees from a fake-world child; one full-size cell from
the CLI in a child.  Children run at nice 10 (``tests/torch_ranks.py``).
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import comm
from repro_torch.analysis.roofline import roofline_from_artifacts
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, smoke_config
from repro_torch.configs.shapes import Shape
from repro_torch.core.space import gemm_input
from repro_torch.kernels import dispatch
from repro_torch.kernels import matmul as kmatmul
from repro_torch.kernels import ops as tops
from repro_torch.launch import dryrun
from repro_torch.models import MOE, MOE_DENSE
from repro_torch.tunedb.obs import get_registry
from repro_torch.tunedb.store import RecordStore, TuneRecord, install_serving
from repro_torch.tunedb.telemetry import get_telemetry

from torch_ranks import finish, load_ranks, start_child, start_ranks

KINDS = {"train": Shape("tiny_train", "train", 16, 2),
         "prefill": Shape("tiny_prefill", "prefill", 16, 2),
         "decode": Shape("tiny_decode", "decode", 16, 2)}
HELD = ("smollm-135m", "dbrx-132b", "mamba2-1.3b", "whisper-base")
EXACT = ("gemm_calls", "flops_gemm", "reduce_calls", "flops_aten",
         "bytes_accessed", "aten_ops")
# the reference's artifact keys (src/repro/launch/dryrun.py run_cell)
REF_KEYS = {"arch", "shape", "mesh", "chips", "kind", "tag", "params",
            "active_params", "model_flops", "overrides", "cost", "memory",
            "collectives"}
CLI_CELLS = ("smollm-135m:decode_32k:pod", "llama3-405b:long_500k:pod")

JAX = r"""
import json, sys
from repro.launch import dryrun as jd
import jax.numpy as jnp
from repro.configs import SHAPES, applicable, get_config, registry
out = {}
for a in registry.ARCH_NAMES:
    cfg = get_config(a)
    out[a] = {"state": jnp.dtype(jd.opt_config_for(cfg).state_dtype).name,
              "micro": jd.train_microbatches(cfg),
              "acc": jnp.dtype(jd.grad_accum_dtype(cfg)).name,
              "skip": {s: list(applicable(cfg, s)) for s in SHAPES},
              "names": {f"{s}|{m}|{t}": jd.artifact_path(a, s, m, t).name
                        for s in SHAPES for m in ("pod", "multipod")
                        for t in ("", "exp1")}}
json.dump(out, open(sys.argv[1], "w"))
"""

FAKE = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import compat
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, smoke_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import tree_leaves
out = {"ep": {}, "argument": {}, "whole": {}}
compat.init_fake_world(8)
mesh = make_host_mesh(model=4, device="cpu")
for a2a in (False, True):
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), moe_a2a=a2a)
    got = dryrun.cell_artifact(cfg, Shape("p", "prefill", 16, 2), mesh)
    out["ep"][str(a2a)] = [got["collectives"], got["memory"]["argument"]]
dist.destroy_process_group()
# the expert slabs' argument bytes on the production mesh (tp = 16)
compat.init_fake_world(256)
mesh = dryrun.production_mesh("pod")
for arch in ("dbrx-132b", "jamba-v0.1-52b"):
    cell = dryrun.build_cell(get_config(arch), SHAPES["train_4k"], mesh)
    out["argument"][arch] = dryrun.argument_bytes(cell)
dist.destroy_process_group()
# every full CONFIG's train_4k state and batch on meta, no mesh (built,
# not run): its argument bytes and its parameter tree's sizes
for arch in ARCH_NAMES:
    cell = dryrun.build_cell(get_config(arch), SHAPES["train_4k"])
    leaves = tree_leaves(cell.state["params"])
    out["whole"][arch] = {
        "argument": dryrun.argument_bytes(cell),
        "numel": sum(t.numel() for t in leaves),
        "bytes": sum(t.numel() * t.element_size() for t in leaves),
        "meta": all(t.device.type == "meta"
                    for t in dryrun._tensors((cell.state, cell.inputs)))}
json.dump(out, open(sys.argv[1], "w"))
"""

# the placed steps (``build_cell(placed=True)``): smollm's and dbrx's
# SMOKE train, prefill and decode, mamba2's (head-parallel TP) train and
# decode, at mesh (data, model) = (2, 2), counted on meta as rank 0 of a
# fake world of 4 and on CPU tensors as rank 0 of a real 4-rank gloo world
PLACED_CELLS = (("smollm-135m", "prefill"), ("smollm-135m", "train"),
                ("dbrx-132b", "prefill"), ("dbrx-132b", "train"),
                ("smollm-135m", "decode"), ("dbrx-132b", "decode"),
                ("mamba2-1.3b", "decode"), ("mamba2-1.3b", "train"))
PLACED = r"""
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
mesh = make_host_mesh(model=2, device="cpu")
for arch, kind in CELLS:
    cell = dryrun.build_cell(smoke_config(arch), Shape("t", kind, 16, 2),
                             mesh, device=DEVICE, placed=True)
    art = dryrun.count_step(cell)
    RESULTS[f"{arch}/{kind}"] = {"cost": art["cost"],
                                 "collectives": art["collectives"],
                                 "argument": dryrun.argument_bytes(cell)}
"""
CELLS_LINE = f"CELLS = {PLACED_CELLS!r}\n"
PLACED_FAKE = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch import compat
compat.init_fake_world(4)
DEVICE, RESULTS = "meta", {}
""" + CELLS_LINE + PLACED + r"""
json.dump(RESULTS, open(sys.argv[1], "w"))
"""
PLACED_RANKS = 'DEVICE = "cpu"\n' + CELLS_LINE + PLACED

# every count of the SMOKE steps with no mesh before the placements: the
# path with no mesh adds no op (aten ops, GEMM calls, FLOPs, bytes; the
# parent tree's ``count_step`` of ``build_cell(cfg, KINDS[kind])``)
NO_MESH_COUNTS = {
    "smollm-135m/train": (1715, 56, 38486016, 45557936),
    "smollm-135m/prefill": (358, 14, 7520256, 2904544),
    "dbrx-132b/train": (2177, 32, 46923776, 72909368),
    "dbrx-132b/prefill": (513, 8, 9863168, 4283972),
    "mamba2-1.3b/train": (1620, 16, 24248320, 36392548),
    "mamba2-1.3b/prefill": (351, 4, 4423680, 4303808),
    "whisper-base/train": (4259, 144, 61734912, 76524540),
    "whisper-base/prefill": (887, 36, 13500416, 5978624),
    "internvl2-76b/train": (1723, 56, 27918336, 34834544),
    "internvl2-76b/prefill": (359, 14, 5111808, 2528576),
}
# the same of a SMOKE decode step with no mesh before its placements (the
# parent tree's ``count_step`` of ``build_cell(cfg, KINDS["decode"])``)
NO_MESH_DECODE_COUNTS = {
    "smollm-135m": (395, 14, 608256, 1081696),
    "dbrx-132b": (434, 8, 1036288, 1539472),
    "mamba2-1.3b": (216, 4, 364544, 999520),
    "whisper-base": (590, 22, 1605632, 1379584),
    "internvl2-76b": (395, 14, 442368, 882224),
}

CLI = r"""
import runpy, sys
sys.argv = ["dryrun", *sys.argv[1:]]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread, the cores left to the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def placed_runs(tmp_path_factory):
    """The placed steps on meta (a fake world of 4) and on CPU tensors
    (rank 0 of 4 gloo ranks), side by side."""
    tmp = tmp_path_factory.mktemp("dryrun_placed")
    procs = start_ranks(PLACED_RANKS, 4, tmp)
    procs.append(start_child(PLACED_FAKE, tmp, "fake4",
                             [str(tmp / "fake4.json")]))
    finish(procs, timeout=300)
    return {"meta": json.loads((tmp / "fake4.json").read_text()),
            "real": load_ranks(tmp, 4)[0]}


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    args = [a for c in CLI_CELLS for a in ("--cell", c)]
    procs = [start_child(JAX, tmp, "jax", [str(tmp / "jax.json")]),
             start_child(FAKE, tmp, "fake", [str(tmp / "fake.json")]),
             start_child(CLI, tmp, "cli", [*args, "--out", str(tmp / "out")])]
    finish(procs, timeout=400)
    return {"jax": json.loads((tmp / "jax.json").read_text()),
            "fake": json.loads((tmp / "fake.json").read_text()),
            "out": tmp / "out", "cli_log": (tmp / "child_cli.log").read_text()}


def _both(cfg, shape):
    """The step counted on meta tensors and on CPU tensors."""
    meta = dryrun.count_step(dryrun.build_cell(cfg, shape))
    real = dryrun.count_step(dryrun.build_cell(cfg, shape, device="cpu"))
    return meta, real


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_artifact_reads_to_finite_roofline_terms(arch, kind):
    """Every arch's SMOKE config at each kind, no mesh: an artifact with
    the reference's keys that the roofline reads to finite terms."""
    art = dryrun.cell_artifact(smoke_config(arch), KINDS[kind], arch=arch)
    assert REF_KEYS <= set(art) and "skipped" not in art
    assert art["chips"] == 1 and art["kind"] == kind
    assert art["cost"]["gemm_calls"] > 0
    assert art["memory"]["peak_per_device"] == (
        art["memory"]["argument"] + art["memory"]["temp"])
    assert art["cost"]["counting"] == dryrun.COUNT_NOTE
    json.dumps(art)
    rt = roofline_from_artifacts(art, recompute_model_flops=False)
    for v in (rt.t_compute, rt.t_memory, rt.t_collective,
              rt.roofline_fraction, rt.useful_ratio):
        assert math.isfinite(v)
    assert rt.t_compute > 0 and rt.t_memory > 0 and rt.t_collective == 0


# ---------------------------------------------------------------------------
# counts against a real run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", HELD)
def test_counts_equal_a_real_cpu_run(arch, kind):
    """GEMM calls, sum 2MNK, reduction passes, aten FLOPs and ops, bytes
    and the temp peak: meta equals the same step on CPU tensors exactly;
    every dispatch GEMM resolution is one counted call."""
    meta, real = _both(smoke_config(arch), KINDS[kind])
    for k in EXACT:
        assert meta["cost"][k] == real["cost"][k], k
    assert meta["cost"]["by_op"] == real["cost"]["by_op"]
    assert meta["memory"]["temp"] == real["memory"]["temp"]
    assert meta["memory"]["argument"] == real["memory"]["argument"]
    gemm = sum(n for key, n in meta["resolutions"].items()
               if key.startswith("gemm/"))
    assert gemm == meta["cost"]["gemm_calls"] > 0


@pytest.mark.parametrize("arch,kind", PLACED_CELLS)
def test_placed_counts_equal_a_real_gloo_rank(placed_runs, arch, kind):
    """At fake world 4 and mesh (2, 2) the placed step's per-rank FLOPs,
    bytes, ops and collective bytes of each kind, counted on meta, equal
    exactly what ``counting()`` gives for rank 0 of a real 4-rank gloo
    run; the rank holds its shards and its block of the cache (argument
    bytes alike).  A decode step gathers weights and all-reduces over
    ``model``, and reduce-scatters nothing.  For SmolLM (a dense decoder)
    the bytes are ``analysis.comm.placed_bytes``'s, its train step's
    with AdamW's global norm."""
    meta = placed_runs["meta"][f"{arch}/{kind}"]
    real = placed_runs["real"][f"{arch}/{kind}"]
    for k in EXACT + ("flops", "bytes_aten"):
        assert meta["cost"][k] == real["cost"][k], k
    assert meta["cost"]["by_op"] == real["cost"]["by_op"]
    assert meta["collectives"] == real["collectives"]
    if arch == "smollm-135m":
        assert meta["collectives"] == comm.placed_bytes(
            smoke_config(arch), B=2, S=16, sizes={"data": 2, "model": 2},
            kind=kind, adamw=kind == "train")
    assert meta["collectives"]["all-gather"] > 0
    if kind == "decode":
        assert meta["collectives"]["all-reduce"] > 0
        assert meta["collectives"]["reduce-scatter"] == 0
    else:
        assert meta["collectives"]["reduce-scatter"] > 0
    assert meta["argument"] == real["argument"]


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", sorted({a.split("/")[0]
                                         for a in NO_MESH_COUNTS}))
def test_the_path_with_no_mesh_adds_no_op(arch, kind):
    """With no mesh, a SMOKE train step and prefill make the ops, GEMM
    calls, FLOPs and bytes they made before the placements."""
    c = dryrun.count_step(dryrun.build_cell(smoke_config(arch),
                                            KINDS[kind]))["cost"]
    assert (c["aten_ops"], c["gemm_calls"], c["flops"],
            c["bytes_accessed"]) == NO_MESH_COUNTS[f"{arch}/{kind}"]


@pytest.mark.parametrize("arch", sorted(NO_MESH_DECODE_COUNTS))
def test_the_decode_path_with_no_mesh_adds_no_op(arch):
    """With no mesh, a SMOKE decode step makes the ops, GEMM calls, FLOPs
    and bytes it made before the decode placements (ROADMAP A8.3)."""
    c = dryrun.count_step(dryrun.build_cell(smoke_config(arch),
                                            KINDS["decode"]))["cost"]
    assert (c["aten_ops"], c["gemm_calls"], c["flops"],
            c["bytes_accessed"]) == NO_MESH_DECODE_COUNTS[arch]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", HELD)
def test_replayed_meta_ops_count_as_run_ones(arch, kind, monkeypatch):
    """On meta the counting mode runs an op once per input metadata and
    replays it after: every count, the ops by name and the temp peak are
    those of the step with every meta op run."""
    cfg = smoke_config(arch)
    replayed = dryrun.count_step(dryrun.build_cell(cfg, KINDS[kind]))
    monkeypatch.setattr(dryrun, "_replayable", lambda func: False)
    run = dryrun.count_step(dryrun.build_cell(cfg, KINDS[kind]))
    assert replayed["cost"] == run["cost"]
    assert replayed["memory"] == run["memory"]
    assert replayed["resolutions"] == run["resolutions"]


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("arch", HELD)
def test_flops_equal_flop_counter_mode(arch, kind, monkeypatch):
    """The real CPU step under torch's ``FlopCounterMode`` with the GEMM
    as one ``torch.mm`` (2MNK; no split K without a store) counts the
    dry-run's total FLOPs."""
    cfg = smoke_config(arch)
    meta = dryrun.count_step(dryrun.build_cell(cfg, KINDS[kind]))
    assert meta["cost"]["reduce_calls"] == 0
    cell = dryrun.build_cell(cfg, KINDS[kind], device="cpu")
    monkeypatch.setattr(kmatmul, "gemm", lambda a, b, c: (a @ b)[None])
    with dispatch.quiet(), FlopCounterMode(display=False) as fc:
        cell.run()
    assert fc.get_total_flops() == meta["cost"]["flops"]


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_split_k_gemm_bytes_equal_the_formula(device):
    """One GEMM through ``dispatch.matmul2`` resolved to a k_split=4
    record: A, B and 4 partials written, then 4 partials read and the
    result written; no other op moves a byte."""
    M, N, K, ks = 64, 96, 512, 4
    cfg = {**tops.DEFAULT_GEMM, "bm": 64, "bn": 64, "bk": 64, "k_split": ks}
    store = RecordStore()
    store.add(TuneRecord(space="gemm", inputs=gemm_input(M, N, K, 32),
                         config=cfg, tflops=1.0))
    install_serving(store=store, models=None, fingerprint=None,
                    build_plan=False)
    try:
        x = torch.zeros((2, M // 2, K), device=device)
        w = torch.zeros((K, N), device=device)
        with dispatch.quiet() as tiers, dryrun.counting((x, w)) as c:
            y = dispatch.matmul2(x, w)
    finally:
        install_serving(store=None, models=None, fingerprint=None,
                        build_plan=False)
    assert tuple(y.shape) == (2, M // 2, N) and y.device.type == device
    assert tiers == {("gemm", "exact"): 1}
    assert (c.gemm_calls, c.reduce_calls) == (1, 1)
    assert c.bytes_gemm == 4 * (M * K + K * N + ks * M * N)
    assert c.bytes_reduce == 4 * (ks + 1) * M * N
    assert c.bytes == c.bytes_gemm + c.bytes_reduce
    assert (c.flops_gemm, c.flops_reduce) == (2 * M * N * K, (ks - 1) * M * N)
    # the partials and the result, each made once
    assert c.temp == 4 * (ks * M * N + M * N)


# ---------------------------------------------------------------------------
# collectives and memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("a2a", [False, True])
def test_moe_mesh_collectives_equal_the_formula(children, a2a):
    """dbrx-132b's SMOKE prefill in a fake world of 8 on the (2, 4) host
    mesh, through ``moe_ep`` / ``moe_ep_a2a``: the collective bytes are
    ``analysis.comm.moe_bytes`` times the layers; the expert leaves are
    each rank's slab of 1 of the 4 experts."""
    cfg = dataclasses.replace(smoke_config("dbrx-132b"), moe_a2a=a2a)
    got, arg = children["fake"]["ep"][str(a2a)]
    one = comm.moe_bytes("moe_ep_a2a" if a2a else "moe_ep", B=2, S=16,
                         D=cfg.d_model, n_experts=cfg.n_experts,
                         top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, tp=4,
                         itemsize=4)
    assert got == {k: cfg.n_layers * v for k, v in one.items()}
    assert got["total"] > 0
    whole = dryrun.argument_bytes(dryrun.build_cell(cfg, KINDS["prefill"]))
    experts = 3 * cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff * 4
    assert arg == whole - experts * 3 // 4


def _moe_layers(cfg) -> int:
    return cfg.n_repeats * sum(1 for _, mlp in cfg.pattern
                               if mlp in (MOE, MOE_DENSE))


def _argument_formula(cfg, shape, tree, tp: int = 1) -> int:
    """Parameters (``tree``: ``init_params``' whole tree's element count
    and bytes; the expert leaves over ``tp``), AdamW's m and v for each in
    ``opt_config_for``'s dtype, the accumulators over more than one
    microbatch in ``grad_accum_dtype``, and the batch."""
    s = torch.finfo(cfg.dtype).bits // 8
    cut = _moe_layers(cfg) * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    cut -= cut // tp
    n = tree["numel"] - cut
    params = tree["bytes"] - cut * s
    state = torch.finfo(dryrun.opt_config_for(cfg).state_dtype).bits // 8
    acc = (torch.finfo(dryrun.grad_accum_dtype(cfg)).bits // 8
           if dryrun.train_microbatches(cfg) > 1 else 0)
    batch = shape.global_batch * (shape.seq_len - cfg.n_frontend_tokens) * 4
    batch += shape.global_batch * cfg.n_frontend_tokens * cfg.d_model * s
    batch += shape.global_batch * cfg.encoder_len * cfg.d_model * s
    return params + n * (2 * state + acc) + batch


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_argument_bytes_equal_the_formula(children, arch):
    """Each full CONFIG's ``train_4k`` state and batch on meta, no mesh
    (built in the fake-world child, not run)."""
    cfg, shape = get_config(arch), SHAPES["train_4k"]
    got = children["fake"]["whole"][arch]
    assert got["argument"] == _argument_formula(cfg, shape, got)
    # the tree is the reference's count (which leaves out the q/k norm
    # scales and the Mamba mixer's conv, decay, skip and norm leaves)
    attn = cfg.n_repeats * sum(1 for mix, _ in cfg.pattern if mix == "attn")
    if all(mix == "attn" for mix, _ in cfg.pattern):
        assert got["numel"] == cfg.param_count + (2 * cfg.hd * attn
                                                  if cfg.qk_norm else 0)
    assert got["meta"]


@pytest.mark.parametrize("arch", ["dbrx-132b", "jamba-v0.1-52b"])
def test_argument_bytes_of_expert_slabs(children, arch):
    """On the 256-rank production mesh (model = 16) each rank holds
    1/16 of every expert leaf and the rest whole."""
    got = children["fake"]
    assert got["argument"][arch] == _argument_formula(
        get_config(arch), SHAPES["train_4k"], got["whole"][arch], tp=16)


# ---------------------------------------------------------------------------
# the reference's policies and names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_policies_skips_and_names_equal_the_reference(children, arch):
    """``opt_config_for``, ``train_microbatches``, ``grad_accum_dtype``,
    each shape's skip reason (a skipped cell's artifact carries it) and
    the artifact file names, against the reference's."""
    want = children["jax"][arch]
    cfg = get_config(arch)
    name = lambda dt: str(dt).split(".")[-1]      # noqa: E731
    assert name(dryrun.opt_config_for(cfg).state_dtype) == want["state"]
    assert dryrun.train_microbatches(cfg) == want["micro"]
    assert name(dryrun.grad_accum_dtype(cfg)) == want["acc"]
    for s in SHAPES:
        ok, reason = want["skip"][s]
        if ok:
            assert dryrun.applicable(cfg, s) == (True, "")
        else:
            art = dryrun.cell_artifact(cfg, SHAPES[s], arch=arch)
            assert art["skipped"] == reason and "cost" not in art
    for key, fname in want["names"].items():
        s, m, t = key.split("|")
        assert dryrun.artifact_path(arch, s, m, t).name == fname


# ---------------------------------------------------------------------------
# serving state, the CLI, the wrappers on meta
# ---------------------------------------------------------------------------

def test_a_dry_run_leaves_serving_state_as_found():
    """With an empty store installed (every GEMM on the degraded tier):
    dispatch's tier counts, the telemetry, the degraded counter and the
    warn-once set are as before; the artifact keeps its resolutions."""
    install_serving(store=RecordStore(), models=None, fingerprint=None,
                    build_plan=False)
    try:
        ctr = get_registry().counter("tunedb_dispatch_degraded_calls_total")
        before = (dict(dispatch.tier_counts), get_telemetry().total(),
                  ctr.value(reason="untuned", space="gemm"),
                  set(dispatch._WARNED))
        art = dryrun.cell_artifact(smoke_config("smollm-135m"),
                                   KINDS["prefill"])
        after = (dict(dispatch.tier_counts), get_telemetry().total(),
                 ctr.value(reason="untuned", space="gemm"),
                 set(dispatch._WARNED))
    finally:
        install_serving(store=None, models=None, fingerprint=None,
                        build_plan=False)
    assert after == before
    assert art["resolutions"] == {"gemm/degraded": art["cost"]["gemm_calls"]}


def test_quiet_and_observed_blocks_restore_and_do_not_nest():
    """``dispatch.quiet`` and ``matmul.observed`` leave dispatch and the
    GEMM wrappers as they were after the block, also after an error, and
    refuse a second block inside the first."""
    a, b = torch.ones((8, 16)), torch.ones((16, 4))
    seen = []

    def observe(name, body, *args):
        seen.append(name)
        return body(*args)

    cfg = tops.shrink_gemm_cfg(dict(tops.DEFAULT_GEMM), 8, 4, 16, 32)
    with dispatch.quiet() as tiers, kmatmul.observed(observe):
        y = dispatch.matmul2(a, b)
        with pytest.raises(RuntimeError):
            with dispatch.quiet():
                pass
        with pytest.raises(RuntimeError):
            with kmatmul.observed(observe):
                pass
    assert torch.equal(y, a @ b) and seen == ["gemm"]
    assert sum(tiers.values()) == 1
    with pytest.raises(ValueError):
        with dispatch.quiet(), kmatmul.observed(observe):
            kmatmul.gemm(a, b[:3], cfg)
    assert dispatch._QUIET is None and kmatmul._OBSERVER is None
    kmatmul.gemm(a, b, cfg)
    assert seen == ["gemm", "gemm"]


def test_the_cli_writes_one_full_size_cell(children):
    """``python -m repro_torch.launch.dryrun --cell ...``: smollm-135m's
    decode_32k on the 256-rank pod mesh measured, llama3-405b's long_500k
    skipped with the rule's reason, both named as the reference names
    them and read by the roofline; never under ``results/dryrun``."""
    out = children["out"]
    assert sorted(p.name for p in out.iterdir()) == [
        "llama3-405b--long_500k--pod.json", "smollm-135m--decode_32k--pod.json"]
    art = json.loads((out / "smollm-135m--decode_32k--pod.json").read_text())
    assert REF_KEYS <= set(art) and art["chips"] == 256
    assert art["cost"]["gemm_calls"] == 210 and art["rules"] == "default"
    rt = roofline_from_artifacts(art)
    assert rt.t_memory > 0 and math.isfinite(rt.roofline_fraction)
    skip = json.loads((out / "llama3-405b--long_500k--pod.json").read_text())
    assert "sub-quadratic" in skip["skipped"]
    assert roofline_from_artifacts(skip).bottleneck == "skipped"
    assert "dry-run: 2 cells, 1 run, 0 failed" in children["cli_log"]
    assert dryrun.RESULTS.parts[-2:] == ("results", "dryrun_torch")


GEMM_CFGS = [dict(tops.DEFAULT_GEMM),
             {**tops.DEFAULT_GEMM, "bm": 32, "bn": 64, "bk": 64,
              "k_split": 4, "prefetch": 3}]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", GEMM_CFGS)
def test_gemm_and_reduce_on_meta_match_the_plain_result(cfg, dtype):
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal((40, 300))).to(dtype)
    b = torch.as_tensor(rng.standard_normal((300, 72))).to(dtype)
    small = tops.shrink_gemm_cfg(cfg, 40, 72, 300, torch.finfo(dtype).bits)
    counts = (kmatmul.launches, kmatmul.reduce_launches)
    parts = kmatmul.gemm(a.to("meta"), b.to("meta"), small)
    want = kmatmul.matmul_plain(a, b, small)
    assert parts.device.type == "meta"
    assert (parts.shape, parts.dtype) == (want.shape, want.dtype)
    out = kmatmul.splitk_reduce(parts)
    red = kmatmul.splitk_reduce_plain(want)
    assert (out.shape, out.dtype) == (red.shape, red.dtype)
    assert (kmatmul.launches, kmatmul.reduce_launches) == counts
    with pytest.raises(ValueError):
        kmatmul.gemm(a.to("meta"), b.to("meta")[:10], small)
