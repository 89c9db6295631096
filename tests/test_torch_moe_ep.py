"""The port's expert-parallel MoE paths (``models/moe.py`` ``moe_ep``,
``moe_ep_a2a``) and the model's choice between them (``models/model.py``
``_moe``) against the JAX package, on four ``gloo`` ranks at meshes
(data, model) = (1, 4) and (2, 2), and at (4, 1), whose model groups
hold one rank each.

One module fixture starts the four ranks and one JAX child on 4 forced
host devices side by side; both read the same numpy inputs, and the
model-level cases the same parameters (the port's SMOKE init, seeded).

What is compared, by the reference's own semantics:
  * outputs of both paths at capacity factors 8.0 (no drops) and 1.0
    against the reference's same path on the same mesh shape: at 1.0
    ``moe_ep_a2a`` drops what the capacity at S/tp drops, not what
    ``moe`` drops;
  * gradients of every leaf and of x against the no-mesh ``moe``'s
    (the loss sum(out * cot)), and with the aux loss added: ``moe_ep``
    against ``moe``; ``moe_ep_a2a`` against the gradient of its own loss
    (the model-axis mean of each sequence slice's aux loss) computed with
    no mesh;
  * the aux loss: ``moe_ep``'s is the no-mesh one; ``moe_ep_a2a``'s the
    mean of the slices'.  The reference's EP paths take the aux loss of
    one batch shard where the batch is split over ``data`` (at (2, 2)
    its value is data shard 0's), which the port, holding the whole
    batch on every rank, does not reproduce (ROADMAP §C).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import init_params
from repro_torch.models import moe as TM

from torch_ranks import finish, load_ranks, start_child, start_ranks

E, K, D, F, B, S = 8, 2, 32, 64, 2, 16
MESHES = ((1, 4), (2, 2))
PATHS = ("ep", "a2a")
ARCHS = ("dbrx-132b", "arctic-480b")
MB, MS = 4, 8                    # the model-level prompts
LOGIT_TOL = 1e-3                 # model logits, fp32, relative to their max
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
LEAVES = ("router", "w_gate", "w_up", "w_down")


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


RANKS = r"""
import numpy as np
from repro_torch.analysis import comm
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_cache, prefill
from repro_torch.models import moe as TM
from repro_torch.parallel import sharding as shd
import dataclasses

inp = dict(np.load(sys.argv[5]))
E, K = 8, 2
p32 = {k: torch.from_numpy(inp[k]) for k in ("router", "w_gate", "w_up",
                                             "w_down")}
x32, cot = torch.from_numpy(inp["x"]), torch.from_numpy(inp["cot"])
FNS = {"ep": TM.moe_ep, "a2a": TM.moe_ep_a2a, "moe": TM.moe}

def run(name, mesh, cf, p=p32, x=x32, grads=False, with_aux=False):
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf)
    if mesh is not None:
        kw["mesh"] = mesh
    if not grads:
        with torch.no_grad():
            out, aux = FNS[name](p, x, **kw)
        return {"out": out.float(), "aux": aux}
    pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xx = x.clone().requires_grad_(True)
    out, aux = FNS[name](pp, xx, **kw)
    loss = (out * cot).sum() + (aux if with_aux else 0.0)
    loss.backward()
    return {"x": xx.grad, **{k: v.grad for k, v in pp.items()}}

pbf = {k: (v if k == "router" else v.to(torch.bfloat16))
       for k, v in p32.items()}
RESULTS["moe"] = run("moe", None, 8.0)
for model in (4, 2, 1):
    mesh = make_host_mesh(model, device="cpu")
    tag = f"{WORLD // model}x{model}"
    RESULTS[tag + "/rank"] = mesh.get_local_rank("model")
    for name in ("ep", "a2a"):
        for cf in (8.0, 1.0):
            RESULTS[f"{tag}/{name}/{cf}"] = run(name, mesh, cf)
        RESULTS[f"{tag}/{name}/grad"] = run(name, mesh, 8.0, grads=True)
        RESULTS[f"{tag}/{name}/grad_aux"] = run(name, mesh, 8.0, grads=True,
                                                with_aux=True)
        RESULTS[f"{tag}/{name}/bf16"] = run(name, mesh, 8.0, p=pbf,
                                            x=x32.to(torch.bfloat16))

# the model level: prefill under use_rules, the experts as rank slabs
toks = torch.from_numpy(inp["tokens"])
for arch in ("dbrx-132b", "arctic-480b"):
    params = {}
    for key, v in inp.items():
        if key.startswith(arch + ":"):
            node = params
            *head, last = key.split(":", 1)[1].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.from_numpy(v)
    base = smoke_config(arch)
    B, L = toks.shape
    with torch.no_grad():
        lg, c = prefill(params, base, {"tokens": toks},
                        init_cache(base, B, L, torch.device("cpu")))
    RESULTS[f"{arch}/none"] = (lg, c["pos0"]["attn"]["k"])
    for model in (4, 2, 1):
        mesh = make_host_mesh(model, device="cpu")
        tag = f"{WORLD // model}x{model}"
        mine = shd.expert_slabs(params, mesh)
        for a2a in (False, True):
            cfg = dataclasses.replace(base, moe_a2a=a2a)
            with torch.no_grad(), shd.use_rules(mesh), comm.record() as ops:
                lg, c = prefill(mine, cfg, {"tokens": toks},
                                init_cache(cfg, B, L, torch.device("cpu")))
            RESULTS[f"{arch}/{tag}/{a2a}"] = (
                lg, c["pos0"]["attn"]["k"], c["pos0"]["attn"]["v"],
                sorted({op.kind for op in ops}),
                tuple(mine["layers"]["pos0"]["moe"]["w_gate"].shape))
"""

JAX = r"""
import dataclasses, os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, jax.numpy as jnp, numpy as np
from repro.compat import auto_axis_types, make_mesh
from repro.configs import registry
from repro.models import init_cache, prefill
from repro.models import moe as JM
from repro.parallel.sharding import use_rules

inp = dict(np.load(sys.argv[1]))
E, K = 8, 2
p32 = {k: jnp.asarray(inp[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
x32, cot = jnp.asarray(inp["x"]), jnp.asarray(inp["cot"])
FNS = {"ep": JM.moe_ep, "a2a": JM.moe_ep_a2a, "moe": JM.moe}
res = {}

def a2a_aux(x, p, tp):
    # the model-axis mean of each S/tp slice's aux loss, whole batch
    Bx, Sx, _ = x.shape
    out = 0.0
    for m in range(tp):
        xs = x[:, m * Sx // tp:(m + 1) * Sx // tp]
        lg = jnp.einsum("bsd,de->bse", xs.astype(jnp.float32), p["router"])
        _, idx = JM._route(lg.reshape(-1, E), K)
        out = out + JM._aux_loss(lg, idx.reshape(Bx, -1, K), E)
    return out / tp

def grad_fn(name, mesh, with_aux, aux_fn=None):
    kw = dict(n_experts=E, top_k=K, capacity_factor=8.0)
    if mesh is not None:
        kw["mesh"] = mesh
    def loss(p, x):
        out, aux = FNS[name](p, x, **kw)
        if aux_fn is not None:
            aux = aux_fn(x, p)
        return jnp.sum(out * cot) + (aux if with_aux else 0.0)
    def fn(p, x):
        gp, gx = jax.grad(loss, argnums=(0, 1))(p, x)
        return {"x": gx, **gp}
    return fn

def fwd_fn(name, mesh, cf):
    kw = dict(n_experts=E, top_k=K, capacity_factor=cf)
    if mesh is not None:
        kw["mesh"] = mesh
    def fn(p, x):
        out, aux = FNS[name](p, x, **kw)
        return {"out": out.astype(jnp.float32), "aux": aux}
    return fn

PROGS = []          # (lowered program, its arguments, where results go)

def lower(fn, args, store):
    PROGS.append((jax.jit(fn).lower(*args), args, store))

def store_cases(out):
    for tag, d in out.items():
        for k, v in d.items():
            res[f"{tag}/{k}"] = np.asarray(v)

def add_cases(cases):
    # every case of one mesh in one program: one compile
    def prog(p, x, pbf, xbf):
        return {tag: (fn(pbf, xbf) if bf else fn(p, x))
                for tag, (fn, bf) in cases.items()}
    lower(prog, (p32, x32, pbf, xbf), store_cases)

pbf = {k: (v if k == "router" else v.astype(jnp.bfloat16))
       for k, v in p32.items()}
xbf = x32.astype(jnp.bfloat16)
route = lambda p, x: {"idx": JM._route(
    jnp.einsum("bsd,de->bse", x, p["router"]).reshape(-1, E), K)[1]}
cases = {"route": (route, False)}
cases.update({f"moe/{cf}": (fwd_fn("moe", None, cf), False)
              for cf in (8.0, 1.0)})
cases["moe/grad"] = (grad_fn("moe", None, False), False)
cases["moe/grad_aux"] = (grad_fn("moe", None, True), False)
for tp in (4, 2):
    tag = "1x4" if tp == 4 else "2x2"
    # the port's a2a loss with no mesh: the same out at factor 8, the
    # slices' mean aux loss over the whole batch
    aux_fn = lambda x, p, tp=tp: a2a_aux(x, p, tp)
    cases[f"{tag}/a2a/grad_aux"] = (grad_fn("moe", None, True, aux_fn),
                                    False)
    cases[f"{tag}/a2a/whole_batch"] = (
        lambda p, x, f=aux_fn: {"aux": f(x, p)}, False)
add_cases(cases)
for shape in ((1, 4), (2, 2)):
    mesh = make_mesh(shape, ("data", "model"), axis_types=auto_axis_types(2))
    tag = f"{shape[0]}x{shape[1]}"
    cases = {}
    for name in ("ep", "a2a"):
        for cf in (8.0, 1.0):
            cases[f"{tag}/{name}/{cf}"] = (fwd_fn(name, mesh, cf), False)
        cases[f"{tag}/{name}/grad"] = (grad_fn(name, mesh, False), False)
        if shape == (1, 4):
            cases[f"{tag}/{name}/grad_aux_mesh"] = (
                grad_fn(name, mesh, True), False)
        cases[f"{tag}/{name}/bf16"] = (fwd_fn(name, mesh, 8.0), True)
    add_cases(cases)

toks = jnp.asarray(inp["tokens"])
for arch in ("dbrx-132b", "arctic-480b"):
    params = {}
    for key, v in inp.items():
        if key.startswith(arch + ":"):
            node = params
            *head, last = key.split(":", 1)[1].split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = jnp.asarray(v)
    base = registry.smoke_config(arch)
    B, L = toks.shape
    for shape in ((1, 4), (2, 2)):
        mesh = make_mesh(shape, ("data", "model"),
                         axis_types=auto_axis_types(2))
        def f(p, t, mesh=mesh, base=base):
            out = {}
            with use_rules(mesh):
                for a2a in (False, True):
                    cfg = dataclasses.replace(base, moe_a2a=a2a)
                    lg, c = prefill(p, cfg, {"tokens": t},
                                    init_cache(cfg, B, L))
                    tag = f"{arch}/{shape[0]}x{shape[1]}/{a2a}"
                    out[tag] = {"logits": lg, "k": c["pos0"]["attn"]["k"],
                                "v": c["pos0"]["attn"]["v"]}
            return out
        lower(f, (params, toks), store_cases)

# XLA compiles and runs outside the GIL: the programs go side by side
with ThreadPoolExecutor(4) as pool:
    outs = list(pool.map(lambda prog: jax.block_until_ready(
        prog[0].compile()(*prog[1])), PROGS))
for out, (_, _, store) in zip(outs, PROGS):
    store(out)
np.savez(sys.argv[2], **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    rng = np.random.default_rng(0)
    f32 = lambda *s, scale=1.0: (rng.standard_normal(s) * scale
                                 ).astype(np.float32)
    inp = {"router": f32(D, E, scale=D ** -0.5),
           "w_gate": f32(E, D, F, scale=D ** -0.5),
           "w_up": f32(E, D, F, scale=D ** -0.5),
           "w_down": f32(E, F, D, scale=F ** -0.5),
           "x": f32(B, S, D), "cot": f32(B, S, D),
           "tokens": rng.integers(0, 512, (MB, MS)).astype(np.int32)}
    for seed, arch in enumerate(ARCHS):
        params = init_params(smoke_config(arch),
                             torch.Generator().manual_seed(seed))
        for k, v in _flat(params).items():
            inp[f"{arch}:{k}"] = v.numpy()
    np.savez(tmp / "inputs.npz", **inp)
    procs = start_ranks(RANKS, 4, tmp, [str(tmp / "inputs.npz")])
    procs.append(start_child(JAX, tmp, "jax", [str(tmp / "inputs.npz"),
                                               str(tmp / "jax.npz")]))
    finish(procs)
    return {"ranks": load_ranks(tmp, 4), "ref": dict(np.load(tmp / "jax.npz")),
            "inp": inp}


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _expert_rows(rank_res: dict, shape, tag: str, leaf: str):
    """(first expert, slab) of one rank's gradient of an expert leaf."""
    m = rank_res[f"{_tag(shape)}/rank"]
    e_loc = E // shape[1]
    return m * e_loc, rank_res[tag][leaf][m * e_loc:(m + 1) * e_loc]


def _grads_close(runs, shape, got_tag: str, want: str, tol=TOL):
    ref = runs["ref"]
    for r in runs["ranks"]:
        got = r[got_tag]
        np.testing.assert_allclose(got["x"].numpy(), ref[f"{want}/x"], **tol)
        np.testing.assert_allclose(got["router"].numpy(),
                                   ref[f"{want}/router"], **tol)
        for leaf in LEAVES[1:]:
            e0, slab = _expert_rows(r, shape, got_tag, leaf)
            np.testing.assert_allclose(
                slab.numpy(), ref[f"{want}/{leaf}"][e0:e0 + len(slab)],
                **tol)


def test_expert_ids_equal_the_reference(runs):
    x = torch.from_numpy(runs["inp"]["x"]).reshape(-1, D)
    _, idx = TM._route(x @ torch.from_numpy(runs["inp"]["router"]), K)
    got = np.sort(idx.numpy(), -1)
    assert (got == np.sort(runs["ref"]["route/idx"], -1)).all()


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_outputs_equal_the_reference_on_the_same_mesh(runs, shape, path, cf):
    tag = f"{_tag(shape)}/{path}/{cf}"
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[tag]["out"].numpy(),
                                   runs["ref"][tag + "/out"], **TOL)


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_ep_aux_is_the_no_mesh_one(runs, shape, cf):
    ref = runs["ref"]
    for r in runs["ranks"]:
        aux = float(r[f"{_tag(shape)}/ep/{cf}"]["aux"])
        np.testing.assert_allclose(aux, ref[f"moe/{cf}/aux"], **TOL)
    if shape == (1, 4):             # no batch split: the reference's too
        np.testing.assert_allclose(ref[f"1x4/ep/{cf}/aux"],
                                   ref[f"moe/{cf}/aux"], **TOL)


@pytest.mark.parametrize("cf", [8.0, 1.0])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_moe_ep_a2a_aux_is_the_mean_of_the_slices(runs, shape, cf):
    ref = runs["ref"]
    want = ref[f"{_tag(shape)}/a2a/whole_batch/aux"]
    for r in runs["ranks"]:
        aux = float(r[f"{_tag(shape)}/a2a/{cf}"]["aux"])
        np.testing.assert_allclose(aux, want, **TOL)
    if shape == (1, 4):
        np.testing.assert_allclose(ref[f"1x4/a2a/{cf}/aux"], want, **TOL)


def test_moe_ep_a2a_drops_differ_from_moe_at_factor_1(runs):
    """The capacity at S/tp drops other pairs than ``moe``'s: the outputs
    part (so the comparison above is the right one)."""
    for shape in MESHES:
        a2a = runs["ranks"][0][f"{_tag(shape)}/a2a/1.0"]["out"].numpy()
        assert np.abs(a2a - runs["ref"]["moe/1.0/out"]).max() > 1e-3


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_gradients_equal_the_no_mesh_moe(runs, shape, path):
    """loss = sum(out * cot), factor 8: x, router and every expert slab
    against the no-mesh ``moe``'s gradient, and against the reference's
    same path on the same mesh."""
    tag = f"{_tag(shape)}/{path}/grad"
    _grads_close(runs, shape, tag, "moe/grad")
    _grads_close(runs, shape, tag, tag)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_gradients_with_the_aux_loss(runs, shape, path):
    """loss = sum(out * cot) + aux: ``moe_ep`` against the no-mesh
    ``moe``; ``moe_ep_a2a`` against its own loss taken with no mesh; on
    the (1, 4) mesh, where the reference splits no batch, both also
    against the reference's same path."""
    tag = f"{_tag(shape)}/{path}/grad_aux"
    want = "moe/grad_aux" if path == "ep" else tag
    _grads_close(runs, shape, tag, want)
    if shape == (1, 4):
        _grads_close(runs, shape, tag, tag + "_mesh")


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
def test_bf16_outputs_equal_the_reference(runs, shape, path):
    tag = f"{_tag(shape)}/{path}/bf16"
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[tag]["out"].numpy(),
                                   runs["ref"][tag + "/out"], **BF16)


@pytest.mark.parametrize("path", PATHS)
def test_one_rank_model_groups_equal_the_no_mesh_path(runs, path):
    """At (4, 1) each model group is one rank (the counterpart of the
    reference's 1-device mesh test): the EP paths give the port's
    no-mesh ``moe`` bit for bit, and the reference's at its tolerance."""
    for r in runs["ranks"]:
        got = r[f"4x1/{path}/8.0"]
        assert torch.equal(got["out"], r["moe"]["out"])
        assert torch.equal(got["aux"], r["moe"]["aux"])
        np.testing.assert_allclose(got["out"].numpy(),
                                   runs["ref"]["moe/8.0/out"],
                                   rtol=1e-4, atol=1e-5)
        _grads_close(runs, (4, 1), f"4x1/{path}/grad", "moe/grad")


@pytest.mark.parametrize("a2a", [False, True])
@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_equals_the_reference_on_the_same_mesh(runs, arch,
                                                             shape, a2a):
    """The SMOKE's prefill under ``use_rules(mesh)`` with the experts as
    rank slabs: the path the reference takes (all-to-all only with
    ``moe_a2a``), and its logits and K/V rows."""
    tag = f"{arch}/{_tag(shape)}/{a2a}"
    ref = runs["ref"]
    n_exp = smoke_config(arch).n_experts
    for r in runs["ranks"]:
        lg, k, v, kinds, slab = r[tag]
        assert kinds == (["all-gather", "all-reduce", "all-to-all"] if a2a
                         else ["all-reduce"])
        assert slab[1] == n_exp // shape[1]
        w = ref[tag + "/logits"]
        err = np.abs(lg.numpy() - w).max() / np.abs(w).max()
        assert err < LOGIT_TOL, (tag, err)
        np.testing.assert_allclose(k.numpy(), ref[tag + "/k"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), ref[tag + "/v"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("a2a", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_on_one_rank_groups_is_the_no_mesh_one(runs, arch,
                                                             a2a):
    for r in runs["ranks"]:
        lg, k, *_ = r[f"{arch}/4x1/{a2a}"]
        want_lg, want_k = r[f"{arch}/none"]
        assert torch.equal(lg, want_lg) and torch.equal(k, want_k)
