"""The FSDP/TP placements of training, prefill and the decode step
(``models/placed.py``, ``parallel/sharding.py`` ``shard_params`` /
``shard_batch`` / ``gather_params`` / ``shard_cache`` / ``gather_cache``,
the optimizer's global norm over shards) against the JAX package, on
four ``gloo`` ranks at meshes (data, model) = (1, 4), (2, 2) and (4, 1),
for seven SMOKE configs: smollm-135m (3 heads: the sequence-parallel
queries), qwen3-14b (head-TP, ``qk_norm``), dbrx-132b (``moe_ep``),
arctic-480b (``moe_ep_a2a``), jamba-v0.1-52b (head-parallel Mamba
layers), whisper-base (the encoder and cross-attention) and
internvl2-76b (``patch_embeds``); and two Mamba cases: mamba2-1.3b's
SMOKE (H = 8 heads: head-parallel TP) and an override of it that both
packages take, d_model 48 and head dim 32 (H = 3: the data-parallel
fallback at model 2 and 4).

The reference's parameters are drawn here (``jax.random``), carried to
the port by ``params_from_jax`` and cut by ``shard_params``; the batch is
drawn from a numpy seed and cut by ``shard_batch``.  One module fixture
starts the four ranks and one JAX child (4 forced host devices) side by
side.  Checks:

  (i)   each rank's shard is the block of the whole leaf that the
        reference's ``param_shardings`` puts on that device
        (``devices_indices_map``);
  (ii)  ``loss_fn``'s metrics and every gradient leaf, gathered from the
        shards, against the reference's: where the reference's values on
        a mesh equal its values with no mesh, its run with no mesh stands
        in.  The MoE configs' loss is the mean over the data shards of
        each shard's loss (ROADMAP C13: the port's aux loss is the mean
        of the shards'), which the reference computes shard by shard
        with no mesh; arctic's all-to-all path drops by the capacity at
        S/tp, so the reference runs it on a (1, tp) mesh, shard by shard;
  (iii) prefill's logits, each rank's rows, within 1e-3 of their max;
  (iv)  one AdamW step on the shards with clipping active against the
        step on the whole tree;
  (v)   C13 at (2, 2): the port's aux loss is the mean of the shards'
        aux losses; the reference's own value on the mesh, data shard
        0's, is printed beside it;
  (vi)  each rank's block of the KV cache and the SSM state
        (``shard_cache`` of a cache numbered 0, 1, 2, ...) is the one the
        reference's ``cache_specs`` places on its device;
  (vii) a placed prefill into a ``shard_cache`` cache of
        :data:`DECODE_LEN` positions (it divides by 4), then
        :data:`STEPS` decode steps at per-slot indices, one slot crossing
        the rank boundary at position 24 and one starting on it
        (internvl2): each step's logits within :data:`LOGIT_TOL` of the
        reference's ``decode_step``, and the cache gathered
        (``gather_cache``: the conv state from its head-aligned layout)
        within :data:`CACHE_TOL` of the reference's (arctic without
        ``moe_a2a``: decode's MoE is ``moe_decode``, and its prefill then
        drops as the reference's with no mesh).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import init_params as jinit_params
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.configs.shapes import cache_specs
from repro_torch.models import init_params, tree_map
from repro_torch.models.model import param_shapes

from torch_ranks import finish, load_ranks, start_child, start_ranks

ARCHS = ("smollm-135m", "qwen3-14b", "dbrx-132b", "arctic-480b",
         "jamba-v0.1-52b", "whisper-base", "internvl2-76b")
# case -> (arch, config overrides, given to both packages)
CASES = {**{a: (a, {}) for a in ARCHS},
         "arctic-480b": ("arctic-480b", {"moe_a2a": True}),
         "mamba2-1.3b": ("mamba2-1.3b", {}),
         "mamba2-1.3b-h3": ("mamba2-1.3b", {"d_model": 48,
                                            "ssm_head_dim": 32})}
MOE_ARCHS = ("dbrx-132b", "arctic-480b", "jamba-v0.1-52b")
MESHES = ((1, 4), (2, 2), (4, 1))
B, S = 4, 16                      # tokens per row (internvl2: + patches)
GRAD_TOL = 1e-5                   # fp32: max |g - g_ref| / |g_ref|, a leaf,
#   beyond twice the port's own departure from the reference with no mesh
LOSS_TOL = 1e-5                   # fp32: loss, xent, aux, acc (relative)
LOGIT_TOL = 1e-3                  # prefill logits, relative to their max
ADAMW_TOL = 1e-5                  # the step's parameters and moments
CACHE_TOL = 1e-4                  # the decoded cache, relative to its max
DECODE_LEN, STEPS = 48, 4         # the decode cache's length, its steps
SLOT_STARTS = (0, 1, 6, 3)        # each slot's first decode position past
#   the prompt's last: 16 + 6 = 22 reaches the rank boundary at 24 on the
#   third step (internvl2, 24 positions: slot 0 starts on it)


def _tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


UNFLAT = r"""
def unflat(inp, prefix, conv):
    tree = {}
    for key, v in inp.items():
        if not key.startswith(prefix):
            continue
        node = tree
        *head, last = key[len(prefix):].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = conv(v)
    return tree
"""

RANKS = UNFLAT + r"""
import dataclasses, json
import numpy as np
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.configs.shapes import cache_specs
from repro_torch.models import (decode_step, encode, init_cache, loss_fn,
                                prefill, tree_leaves, tree_map)
from repro_torch.models.model import param_shapes
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as shd
from repro_torch.weights import params_from_jax

inp = dict(np.load(sys.argv[5]))
meta = json.loads(sys.argv[6])
OPT = AdamWConfig(lr=1e-2, grad_clip=1e-3, warmup_steps=0)
cpu = torch.device("cpu")

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}

def batch_of(arch):
    return {k.split(":", 2)[2]: torch.from_numpy(v)
            for k, v in inp.items() if k.startswith(f"batch:{arch}:")}

def numbered(tree):
    return tree_map(lambda t: torch.arange(t.numel(), dtype=torch.float32
                                           ).reshape(t.shape).to(t.dtype),
                    tree)

for name, (arch, over) in meta["cases"].items():
    cfg = dataclasses.replace(smoke_config(arch), **over)
    full = params_from_jax(unflat(inp, f"{name}:", lambda v: v), cfg, "cpu")
    batch = batch_of(name)
    L = batch["tokens"].shape[1] + cfg.n_frontend_tokens
    LC = meta["decode_len"]
    dec = torch.from_numpy(inp[f"dec:{name}"])
    starts = L + torch.tensor(meta["starts"])
    dcfg = dataclasses.replace(cfg, moe_a2a=False)
    for model in (4, 2, 1):
        mesh = make_host_mesh(model, device="cpu")
        tag = f"{WORLD // model}x{model}"
        res = {"coords": (mesh.get_local_rank("data"),
                          mesh.get_local_rank("model"))}
        shards = shd.shard_params(full, mesh)
        res["shards"] = {k: v.numpy() for k, v in flat(shards).items()}
        rows = shd.shard_batch(batch, mesh)
        # (ii) the placed loss and its gradients
        mine = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        shards)
        with shd.use_rules(mesh, placed=True):
            loss, m = loss_fn(mine, cfg, rows)
            grads = torch.autograd.grad(loss, tree_leaves(mine),
                                        allow_unused=True,
                                        materialize_grads=True)
        res["metrics"] = {k: float(v) for k, v in m.items()}
        it = iter(grads)
        g_tree = tree_map(lambda _: next(it), mine)
        whole_g = shd.gather_params(g_tree, mesh, param_shapes(cfg))
        if RANK == 0:
            res["grads"] = {k: v.numpy() for k, v in flat(whole_g).items()}
            # the port with no mesh: the mean of the data shards' losses
            nm = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                          full)
            n = WORLD // model
            Bt = batch["tokens"].shape[0]
            loss = sum(loss_fn(nm, cfg, {k: v[d * Bt // n:(d + 1) * Bt // n]
                                         for k, v in batch.items()})[0]
                       for d in range(n)) / n
            g = torch.autograd.grad(loss, tree_leaves(nm), allow_unused=True,
                                    materialize_grads=True)
            res["nomesh_grads"] = {k: v.numpy() for k, v in zip(
                flat(nm), g)}
        # (iv) AdamW on the shards against the whole tree's step
        specs = shd.param_shardings(param_shapes(cfg), mesh)
        p_sh = tree_map(lambda t: t.detach().clone(), shards)
        st = adamw_init(p_sh, OPT)
        _, st, om = adamw_update(p_sh, g_tree, st, OPT, shardings=specs)
        p_w = tree_map(lambda t: t.detach().clone(), full)
        st_w = adamw_init(p_w, OPT)
        _, st_w, om_w = adamw_update(p_w, whole_g, st_w, OPT)
        got = [shd.gather_params(t, mesh, param_shapes(cfg))
               for t in (p_sh, st.m, st.v)]
        err = 0.0
        for a_t, b_t in zip(got, (p_w, st_w.m, st_w.v)):
            for a, b in zip(tree_leaves(a_t), tree_leaves(b_t)):
                err = max(err, float((a - b).abs().max())
                          / max(float(b.norm()), 1e-30))
        res["adamw"] = {"err": err, "norm": float(om["grad_norm"]),
                        "norm_whole": float(om_w["grad_norm"])}
        # (iii) the placed prefill
        with torch.no_grad(), shd.use_rules(mesh, placed=True):
            cache = shd.shard_cache(init_cache(
                cfg, batch["tokens"].shape[0], L, cpu), mesh)
            pre = {k: v for k, v in rows.items() if k != "targets"}
            lg, cache = prefill(shards, cfg, pre, cache)
        res["logits"] = lg.numpy()
        # the refusal: whole parameters
        with torch.no_grad(), shd.use_rules(mesh, placed=True):
            try:
                loss_fn(full, cfg, rows)
                res["whole_refused"] = False
            except ValueError:
                res["whole_refused"] = True
        # (vi) the blocks of a numbered cache
        Bt = batch["tokens"].shape[0]
        blocks = shd.shard_cache(numbered(init_cache(dcfg, Bt, LC, cpu)), mesh)
        res["cache_blocks"] = {k: v.numpy() for k, v in flat(blocks).items()}
        # (vii) prefill, then decode steps at per-slot indices
        with torch.no_grad(), shd.use_rules(mesh, placed=True):
            cache = shd.shard_cache(init_cache(dcfg, Bt, LC, cpu), mesh)
            lg, cache = prefill(shards, dcfg, pre, cache)
            out = [lg]
            mem = (encode(dcfg, shards, rows["encoder_embeds"])
                   if dcfg.is_encdec else None)
            for t in range(dec.shape[1]):
                step = shd.shard_batch({"tokens": dec[:, t:t + 1],
                                        "index": starts + t}, mesh,
                                       whole_rows=True)
                lg, cache = decode_step(shards, dcfg, step["tokens"], cache,
                                        step["index"], memory=mem)
                out.append(lg)
        res["decode"] = [t.numpy() for t in out]
        whole_c = shd.gather_cache(cache, mesh, cache_specs(dcfg, Bt, LC))
        if RANK == 0:
            res["decode_cache"] = {k: v.numpy()
                                   for k, v in flat(whole_c).items()}
        RESULTS[f"{name}/{tag}"] = res
"""

JAX = UNFLAT + r"""
import dataclasses, json, os, sys
from concurrent.futures import ThreadPoolExecutor
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, jax.numpy as jnp, numpy as np
from repro.compat import auto_axis_types, make_mesh
from repro.configs import registry
from repro.configs.shapes import cache_specs
from repro.models import decode_step, encode, init_cache, loss_fn, prefill
from repro.parallel.sharding import param_shardings, use_rules

inp = dict(np.load(sys.argv[1]))
meta = json.loads(sys.argv[3])
res, PROGS = {}, []
mesh_of = lambda shape: make_mesh(shape, ("data", "model"),
                                  axis_types=auto_axis_types(2))

def store(prefix):
    def fn(out):
        for k, v in out.items():
            res[f"{prefix}/{k}"] = np.asarray(v)
    return fn

def lower(fn, args, prefix):
    PROGS.append((jax.jit(fn).lower(*args), args, store(prefix)))

def shard_losses(cfg, n):
    # the mean over n data shards of each shard's loss_fn, no mesh
    def f(p, batch):
        Bt = batch["tokens"].shape[0]
        parts = {k: v.reshape(n, Bt // n, *v.shape[1:])
                 for k, v in batch.items()}
        if n == 1:
            loss, m = loss_fn(p, cfg, batch)
            return loss, {k: v[None] for k, v in m.items()}
        ms = jax.lax.map(lambda part: loss_fn(p, cfg, part)[1], parts)
        return ms["loss"].mean(), ms
    return f

def grad_prog(cfg, n, mesh=None):
    f = shard_losses(cfg, n)
    def prog(p, batch):
        def run():
            (loss, ms), g = jax.value_and_grad(f, has_aux=True)(p, batch)
            return {"loss": loss, **{f"m/{k}": v for k, v in ms.items()},
                    **{f"g/{k}": v for k, v in flat(g).items()}}
        if mesh is None:
            return run()
        with use_rules(mesh):
            return run()
    return prog

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}

def prefill_prog(cfg, L, mesh=None):
    def prog(p, batch):
        b = {k: v for k, v in batch.items() if k != "targets"}
        Bt = b["tokens"].shape[0]
        if mesh is None:
            return {"logits": prefill(p, cfg, b, init_cache(cfg, Bt, L))[0]}
        with use_rules(mesh):
            return {"logits": prefill(p, cfg, b, init_cache(cfg, Bt, L))[0]}
    return prog

def decode_prog(cfg, LC, starts):
    # prefill, then the decode steps at per-slot indices, no mesh
    def prog(p, batch, dec):
        b = {k: v for k, v in batch.items() if k != "targets"}
        Bt = b["tokens"].shape[0]
        lg, cache = prefill(p, cfg, b, init_cache(cfg, Bt, LC))
        out = {"logits/0": lg}
        mem = encode(cfg, p, b["encoder_embeds"]) if cfg.is_encdec else None
        for t in range(dec.shape[1]):
            lg, cache = decode_step(p, cfg, dec[:, t:t + 1], cache,
                                    starts + t, memory=mem)
            out[f"logits/{t + 1}"] = lg
        out.update({f"cache/{k}": v for k, v in flat(cache).items()})
        return out
    return prog

for name, (arch, over) in meta["cases"].items():
    cfg = dataclasses.replace(registry.smoke_config(arch), **over)
    p = unflat(inp, f"{name}:", jnp.asarray)
    batch = {k.split(":", 2)[2]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(f"batch:{name}:")}
    L = batch["tokens"].shape[1] + cfg.n_frontend_tokens
    LC, Bt = meta["decode_len"], batch["tokens"].shape[0]
    dcfg = dataclasses.replace(cfg, moe_a2a=False)
    # (i) the blocks the reference puts on each device
    for shape in meta["meshes"]:
        mesh = mesh_of(tuple(shape))
        tag = f"{shape[0]}x{shape[1]}"
        shards = param_shardings(p, mesh)
        leaves = flat(p)
        blocks = [(path, s.devices_indices_map(leaves[path].shape),
                   leaves[path].shape, "index")
                  for path, s in flat(shards).items()]
        blocks += [(path, sds.sharding.devices_indices_map(sds.shape),
                    sds.shape, "cindex")
                   for path, sds in flat(cache_specs(dcfg, Bt, LC,
                                                     mesh)).items()]
        for path, imap, lshape, kind in blocks:
            for i in range(shape[0]):
                for j in range(shape[1]):
                    idx = imap[mesh.devices[i, j]]
                    res[f"{name}/{tag}/{kind}/{i}/{j}/{path}"] = np.array(
                        [[sl.start or 0, lshape[d] if sl.stop is None
                          else sl.stop] for d, sl in enumerate(idx)])
    # (vii) the decode steps
    lower(decode_prog(dcfg, LC, L + jnp.asarray(meta["starts"])),
          (p, batch, jnp.asarray(inp[f"dec:{name}"])), f"{name}/decode")
    # (ii) the losses the port's meshes take, (iii) the logits
    moe = arch in meta["moe"]
    a2a = cfg.moe_a2a
    for n in ((1, 2, 4) if moe else (1,)):
        tp = 4 // n
        if a2a and tp > 1:
            # all-to-all drops by the capacity at S/tp: the reference's
            # path on a (1, tp) mesh, shard by shard
            lower(grad_prog(cfg, n, mesh_of((1, tp))), (p, batch),
                  f"{name}/grad/{n}")
        else:
            lower(grad_prog(cfg, n), (p, batch), f"{name}/grad/{n}")
    lower(prefill_prog(cfg, L), (p, batch), f"{name}/prefill/none")
    if a2a:
        for tp in (4, 2):
            lower(prefill_prog(cfg, L, mesh_of((1, tp))), (p, batch),
                  f"{name}/prefill/tp{tp}")
    if name == "dbrx-132b":
        # C13: the reference's own aux on the (2, 2) mesh
        mesh = mesh_of((2, 2))
        def on_mesh(p, batch, mesh=mesh, cfg=cfg):
            with use_rules(mesh):
                return loss_fn(p, cfg, batch)[1]
        lower(on_mesh, (p, batch), f"{name}/mesh2x2")

with ThreadPoolExecutor(4) as pool:
    outs = list(pool.map(lambda prog: jax.block_until_ready(
        prog[0].compile()(*prog[1])), PROGS))
for out, (_, _, st) in zip(outs, PROGS):
    st(out)
np.savez(sys.argv[2], **res)
"""


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        out["encoder_embeds"] = rng.standard_normal(
            (B, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("placements")
    inp = {}
    for seed, (name, (arch, over)) in enumerate(CASES.items()):
        jcfg = dataclasses.replace(jregistry.smoke_config(arch), **over)
        jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
        for k, v in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
            inp[f"{name}:{k}"] = v
        for k, v in _batch(jcfg, seed).items():
            inp[f"batch:{name}:{k}"] = v
        inp[f"dec:{name}"] = np.random.default_rng(100 + seed).integers(
            0, jcfg.vocab, (B, STEPS)).astype(np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    meta = json.dumps({"cases": CASES, "moe": MOE_ARCHS, "meshes": MESHES,
                       "decode_len": DECODE_LEN, "starts": SLOT_STARTS})
    procs = start_ranks(RANKS, 4, tmp, [str(tmp / "inputs.npz"), meta])
    procs.append(start_child(JAX, tmp, "jax", [str(tmp / "inputs.npz"),
                                               str(tmp / "jax.npz"), meta]))
    finish(procs, timeout=400)
    return {"ranks": load_ranks(tmp, 4), "ref": dict(np.load(tmp / "jax.npz")),
            "inp": inp}


def _ref_n(arch: str, shape) -> int:
    """The number of data shards whose mean loss the port's equals (the
    whole batch's where the config has no MoE layer)."""
    return shape[0] if arch in MOE_ARCHS else 1


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_shards_are_the_reference_blocks(runs, arch, shape):
    """(i) Each rank's block of every leaf is the one the reference's
    ``NamedSharding`` places on the device at its mesh coordinates."""
    ref, inp = runs["ref"], runs["inp"]
    for r in runs["ranks"]:
        got = r[f"{arch}/{_tag(shape)}"]
        i, j = got["coords"]
        for path, shard in got["shards"].items():
            idx = ref[f"{arch}/{_tag(shape)}/index/{i}/{j}/{path}"]
            want = inp[f"{arch}:{path}"][tuple(slice(a, b) for a, b in idx)]
            assert shard.shape == want.shape, (path, shard.shape, want.shape)
            np.testing.assert_array_equal(shard, want, err_msg=path)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_loss_and_grads_equal_the_reference(runs, arch, shape):
    """(ii) The placed ``loss_fn`` on the shards: its loss, xent, aux and
    accuracy on every rank, and every gradient leaf gathered from the
    shards, against the reference's loss over the same data shards.  A
    leaf's error may exceed :data:`GRAD_TOL` only by twice the port's own
    error on that leaf with no mesh: the fp32 Mamba scan's scalar leaves
    (``a_log``, ``dt_bias``, ``d_skip``: sums with cancellation, whose
    rounding the placed layers before them move) depart from the
    reference's by up to ~1.2e-5 of their norm with no mesh at all.  The
    Mamba layers run head-parallel where their heads divide by the
    ``model`` axis (mamba2-1.3b, jamba-v0.1-52b), else whole on each
    rank (mamba2-1.3b-h3 at model 2 and 4)."""
    ref = runs["ref"]
    pre = f"{arch}/grad/{_ref_n(arch, shape)}"
    for r in runs["ranks"]:
        m = r[f"{arch}/{_tag(shape)}"]["metrics"]
        for k in ("loss", "xent", "aux", "acc"):
            want = float(ref[f"{pre}/m/{k}"].mean())
            assert abs(m[k] - want) <= LOSS_TOL * max(abs(want), 1.0), (
                k, m[k], want)
    got = runs["ranks"][0][f"{arch}/{_tag(shape)}"]
    bad = {}
    for path, g in got["grads"].items():
        want = ref[f"{pre}/g/{path}"]
        scale = max(np.linalg.norm(want), 1e-30)
        err = np.abs(g - want).max() / scale
        own = np.abs(got["nomesh_grads"][path] - want).max() / scale
        if err > GRAD_TOL + 2 * own:
            bad[path] = (err, own)
    assert not bad, bad


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_prefill_logits_equal_the_reference(runs, arch, shape):
    """(iii) Each rank's (B/dp, V) logits against the reference's rows
    (arctic's all-to-all path on a (1, tp) mesh, its drops the port's)."""
    ref = runs["ref"]
    tp = shape[1]
    key = (f"{arch}/prefill/tp{tp}" if CASES[arch][1].get("moe_a2a")
           and tp > 1 else f"{arch}/prefill/none")
    want_all = ref[f"{key}/logits"]
    rows = B // shape[0]
    for r in runs["ranks"]:
        got = r[f"{arch}/{_tag(shape)}"]
        i, _ = got["coords"]
        want = want_all[i * rows:(i + 1) * rows]
        err = np.abs(got["logits"] - want).max() / np.abs(want).max()
        assert err < LOGIT_TOL, err


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_adamw_on_shards_equals_the_whole_step(runs, arch, shape):
    """(iv) One AdamW step on the shards (the global norm over shards,
    clipping active) equals the step on the whole tree once gathered."""
    for r in runs["ranks"]:
        a = r[f"{arch}/{_tag(shape)}"]["adamw"]
        assert a["norm"] > 1e-3                    # the clip is active
        assert abs(a["norm"] - a["norm_whole"]) <= 1e-5 * a["norm_whole"]
        assert a["err"] <= ADAMW_TOL, a


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_path_refuses_whole_params(runs, arch, shape):
    """Whole parameters under a placement are refused where a shard is
    not the whole leaf."""
    for r in runs["ranks"]:
        assert r[f"{arch}/{_tag(shape)}"]["whole_refused"]


def test_c13_aux_is_the_mean_of_the_data_shards(runs):
    """(v) dbrx-132b at (2, 2): the port's aux loss is the mean of the
    two data shards' aux losses (the reference's, shard by shard, no
    mesh); the reference's own value on the mesh is data shard 0's."""
    ref = runs["ref"]
    shards = ref["dbrx-132b/grad/2/m/aux"]
    ref_mesh = float(ref["dbrx-132b/mesh2x2/aux"])
    print(f"C13 at (2, 2): the port's aux {shards.mean():.6f} = mean of "
          f"the shards' {shards.tolist()}; the reference's on the mesh "
          f"{ref_mesh:.6f}")
    for r in runs["ranks"]:
        got = r["dbrx-132b/2x2"]["metrics"]["aux"]
        assert abs(got - shards.mean()) <= LOSS_TOL * shards.mean()
    assert abs(ref_mesh - shards[0]) <= LOSS_TOL * shards[0]
    assert abs(shards[0] - shards[1]) > 1e-3          # a departure indeed


def _numbered(shape) -> np.ndarray:
    return np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_cache_shards_are_the_reference_blocks(runs, arch, shape):
    """(vi) Each rank's block of every KV cache and SSM state is the one
    the reference's ``cache_specs`` places on the device at its mesh
    coordinates: (R, B/dp, L/tp, G, hd) and (R, B/dp, H/tp, P, S) where
    the heads divide.  The conv state's head-aligned layout departs from
    the reference's cut (ROADMAP C14): (vii) holds it gathered."""
    ref = runs["ref"]
    name, over = CASES[arch]
    cfg = dataclasses.replace(smoke_config(name), **{**over, "moe_a2a": False})
    whole = _flat(tree_map(lambda t: tuple(t.shape),
                           cache_specs(cfg, B, DECODE_LEN)))
    n = 0
    for r in runs["ranks"]:
        got = r[f"{arch}/{_tag(shape)}"]
        i, j = got["coords"]
        for path, block in got["cache_blocks"].items():
            if path.endswith("conv"):
                continue
            idx = ref[f"{arch}/{_tag(shape)}/cindex/{i}/{j}/{path}"]
            want = _numbered(whole[path])[tuple(slice(a, b) for a, b in idx)]
            np.testing.assert_array_equal(block, want, err_msg=path)
            n += 1
    assert n


@pytest.mark.parametrize("shape", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", CASES)
def test_decode_logits_and_cache_equal_the_reference(runs, arch, shape):
    """(vii) The placed prefill and each decode step at per-slot indices:
    each rank's (B/dp, V) logits within :data:`LOGIT_TOL` of the
    reference's rows, and the cache gathered from the ranks' blocks
    within :data:`CACHE_TOL` of the reference's, leaf by leaf."""
    ref = runs["ref"]
    rows = B // shape[0]
    for r in runs["ranks"]:
        got = r[f"{arch}/{_tag(shape)}"]
        i, _ = got["coords"]
        assert len(got["decode"]) == STEPS + 1
        for t, lg in enumerate(got["decode"]):
            want = ref[f"{arch}/decode/logits/{t}"][i * rows:(i + 1) * rows]
            err = np.abs(lg - want).max() / np.abs(want).max()
            assert err < LOGIT_TOL, (t, err)
    cache = runs["ranks"][0][f"{arch}/{_tag(shape)}"]["decode_cache"]
    for path, leaf in cache.items():
        want = ref[f"{arch}/decode/cache/{path}"]
        assert leaf.shape == want.shape, path
        err = np.abs(leaf - want).max() / max(np.abs(want).max(), 1e-30)
        assert err < CACHE_TOL, (path, err)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_shapes_equal_init_params(arch):
    cfg = smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    assert (json.dumps(param_shapes(cfg))
            == json.dumps(tree_map(lambda t: tuple(t.shape), params)))
