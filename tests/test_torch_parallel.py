"""The port's mesh factories, sharding rules, input shapes and gpipe
pipeline (``repro_torch.launch.mesh``, ``parallel.sharding``,
``configs.shapes``, ``parallel.pipeline``) against the JAX package.

One module fixture starts, side by side: four ``gloo`` ranks (the
pipeline on a 4-stage mesh, parameter shards on a (2, 2) mesh), a
fake-world child (the production meshes of 256 and 512 ranks and the 40
cells' input specs on the first) and a JAX child on 256 forced host
devices (the reference's specs under its production mesh, its pipeline
on 4 of them)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable as japplicable
from repro.configs import input_specs as jinput_specs
from repro.configs import registry as jregistry
from repro.configs.shapes import make_batch as jmake_batch
from repro.models import init_params as jinit_params
from repro.parallel import sharding as jshd
from repro_torch.configs import (ARCH_NAMES, SHAPES, applicable,
                                 get_config, input_specs, shape_kind)
from repro_torch.configs.shapes import make_batch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import stage_split

from torch_ranks import finish, load_ranks, start_child, start_ranks


class FakeMesh:
    """The reference's stand-in mesh (tests/test_sharding.py)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


MESHES = {"pod": FakeMesh((16, 16), ("data", "model")),
          "multi": FakeMesh((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s) for a in sorted(ARCH_NAMES) for s in SHAPES]
N_STAGES, N_MICRO, N_LAYERS, D = 4, 6, 8, 16
SHARD_ARCHS = ("dbrx-132b", "mamba2-1.3b")


def _norm(spec) -> list:
    """A spec as JSON: per dim None, a name, or a list of names."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def _flat(tree, path="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


RANKS = r"""
import numpy as np
from repro_torch.analysis import comm
from repro_torch.compat import distribute_tensor, DTensor, Replicate
from repro_torch.compat import make_mesh
from repro_torch.configs import smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import init_params
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.pipeline import pipeline_apply, stage_split

inp = np.load(sys.argv[5])
ws, x = torch.from_numpy(inp["ws"]), torch.from_numpy(inp["x"])

def stage_fn(params, h):          # params: (layers_per_stage, d, d)
    for i in range(params.shape[0]):
        h = torch.tanh(h @ params[i])
    return h

stage_mesh = make_mesh((WORLD,), ("stage",), "cpu")
with comm.record() as ops:
    RESULTS["pipeline"] = pipeline_apply(stage_fn, stage_split(ws, WORLD), x,
                                         mesh=stage_mesh)
RESULTS["pipeline_bytes"] = comm.collective_bytes(ops)

mesh = make_host_mesh(2, device="cpu")
RESULTS["host_mesh"] = (tuple(mesh.shape), tuple(mesh.mesh_dim_names))
for arch in sys.argv[6].split(","):
    params = init_params(smoke_config(arch), torch.Generator().manual_seed(0))
    shards = shd.param_shardings(params, mesh)
    out = {}
    def walk(p, s, path):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], s[k], f"{path}/{k}" if path else k)
            return
        local = distribute_tensor(p, mesh, s.placements).to_local()
        out[path] = (tuple(p.shape), s.spec, tuple(local.shape))
    walk(params, shards, "")
    slabs = shd.expert_slabs(params, mesh)
    out["slab"] = tuple(slabs["layers"]["pos0"]["moe"]["w_gate"].shape) \
        if "moe" in params["layers"]["pos0"] else None
    RESULTS[arch] = out

# constrain: a DTensor is redistributed (values kept), a tensor passes
full = torch.arange(32.0).reshape(4, 8)
dt = distribute_tensor(full, mesh, [Replicate(), Replicate()])
with shd.use_rules(mesh):
    c = shd.constrain(dt, "batch", "none")
    RESULTS["constrain"] = (str(c.placements), c.to_local().shape,
                            bool(torch.equal(c.full_tensor(), full)),
                            shd.constrain(full, "batch", "none") is full,
                            shd.axis_size("batch"), shd.axis_size("model"))
"""

FAKE = r"""
import json, sys
import torch.distributed as dist
from repro_torch.compat import init_fake_world
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config, input_specs
from repro_torch.launch.mesh import make_production_mesh

def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{path}/{k}" if path else k))
        return out
    return {path: [list(e) if isinstance(e, tuple) else e
                   for e in tree.sharding.spec]}

out = {}
init_fake_world(256)
mesh = make_production_mesh(device="cpu")
out["pod"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
out["specs"] = {f"{a}|{s}": flat(input_specs(get_config(a), s, mesh))
                for a in ARCH_NAMES for s in SHAPES}
dist.destroy_process_group()
init_fake_world(512)
mesh = make_production_mesh(multi_pod=True, device="cpu")
out["multi"] = [list(mesh.shape), list(mesh.mesh_dim_names)]
dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""

JAX = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=256 "
                           "--xla_cpu_multi_thread_eigen=false")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import SHAPES, input_specs, registry
from repro.launch.mesh import make_production_mesh
from repro.parallel.pipeline import pipeline_apply, stage_split

mesh = make_production_mesh()
specs = {}
for a in registry.ARCH_NAMES:
    for s in SHAPES:
        leaves = jax.tree_util.tree_flatten_with_path(
            input_specs(registry.get_config(a), s, mesh))[0]
        specs[f"{a}|{s}"] = {
            "/".join(str(p.key) for p in path):
            [list(e) if isinstance(e, tuple) else e
             for e in tuple(leaf.sharding.spec)]
            for path, leaf in leaves}
inp = np.load(sys.argv[2])
ws, x = jnp.asarray(inp["ws"]), jnp.asarray(inp["x"])
stages = Mesh(np.array(jax.devices()[:4]), ("stage",))

def stage_fn(params, h):
    for i in range(params.shape[0]):
        h = jnp.tanh(h @ params[i])
    return h

got = jax.jit(lambda w, x: pipeline_apply(stage_fn, stage_split(w, 4), x,
                                          mesh=stages))(ws, x)
np.save(sys.argv[3], np.asarray(got))
json.dump(specs, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((N_LAYERS, D, D)) * 0.2).astype(np.float32)
    x = rng.standard_normal((N_MICRO, 4, D)).astype(np.float32)
    np.savez(tmp / "inputs.npz", ws=ws, x=x)
    procs = start_ranks(RANKS, N_STAGES, tmp,
                        [str(tmp / "inputs.npz"), ",".join(SHARD_ARCHS)])
    procs.append(start_child(FAKE, tmp, "fake", [str(tmp / "fake.json")]))
    procs.append(start_child(JAX, tmp, "jax", [
        str(tmp / "jax.json"), str(tmp / "inputs.npz"),
        str(tmp / "jax_pipeline.npy")]))
    finish(procs)
    return {"ranks": load_ranks(tmp, N_STAGES),
            "fake": json.loads((tmp / "fake.json").read_text()),
            "jax": json.loads((tmp / "jax.json").read_text()),
            "jax_pipeline": np.load(tmp / "jax_pipeline.npy"),
            "ws": ws, "x": x}


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCH_NAMES))
def test_param_specs_equal_the_reference(arch, mesh):
    """For every parameter of the full CONFIG: ``_axes_for`` and
    ``logical_to_spec`` give the reference's, and ``param_shardings``
    (over meta tensors of the reference's shapes) the same spec."""
    fake = MESHES[mesh]
    tree = jax.eval_shape(lambda: jinit_params(jregistry.get_config(arch),
                                               jax.random.PRNGKey(0)))
    leaves = {"/".join(str(p.key) for p in path): leaf.shape
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    meta = {}
    for path, shape in leaves.items():
        node = meta
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = torch.empty(shape, device="meta")
    got = _flat(shd.param_shardings(meta, fake))
    assert set(got) == set(leaves)
    for path, shape in leaves.items():
        stacked = "layers/" in path or "encoder/" in path
        axes = shd._axes_for(path, len(shape), stacked)
        assert axes == jshd._axes_for(path, len(shape), stacked), path
        want = _norm(jshd.logical_to_spec(axes, shape, fake))
        assert _norm(shd.logical_to_spec(axes, shape, fake)) == want, path
        assert _norm(got[path].spec) == want, path


@pytest.mark.parametrize("axes,shape", [
    (("batch", "none"), (256, 4096)), (("batch", "none"), (2, 128)),
    (("batch", "none"), (32, 128)), (("none", "none", "model", "none"),
                                     (2, 64, 9, 64)),
    (("expert", "fsdp", "model"), (16, 6144, 10752)),
    (("seq", "model"), (48, 48)), (("unknown",), (16,))])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_logical_to_spec_edge_cases_equal_the_reference(mesh, axes, shape):
    fake = MESHES[mesh]
    assert (_norm(shd.logical_to_spec(axes, shape, fake))
            == _norm(jshd.logical_to_spec(axes, shape, fake)))


@pytest.mark.parametrize("rules", ["default", "dp_only"])
def test_rule_sets_switch_like_the_reference(rules):
    try:
        shd.set_param_rules(rules)
        jshd.set_param_rules(rules)
        for path in ("layers/pos0/attn/wq", "layers/pos0/moe/w_gate",
                     "embed", "final_norm", "layers/pos0/mamba/conv_b"):
            for ndim in (1, 2, 3, 4):
                assert (shd._axes_for(path, ndim, True)
                        == jshd._axes_for(path, ndim, True))
    finally:
        shd.set_param_rules("default")
        jshd.set_param_rules("default")


def test_batch_spec_replicated_and_axis_size_without_a_mesh():
    fake = MESHES["multi"]
    assert (_norm(shd.batch_spec(fake, (32, 128, 64)).spec)
            == _norm(jshd.logical_to_spec(("batch", "none", "none"),
                                          (32, 128, 64), fake)))
    assert shd.replicated(fake).spec == ()
    assert shd.active_mesh() is None and shd.axis_size("model") == 1
    x = torch.ones(2, 3)
    assert shd.constrain(x, "batch", "none") is x
    with shd.use_rules(fake):
        assert shd.active_mesh() is fake
        assert shd.axis_size("batch") == 32 and shd.axis_size("seq") == 16
        with shd.use_rules(None):
            assert shd.active_mesh() is None
        assert shd.constrain(x, "batch", "none") is x
    assert shd.active_mesh() is None


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_local_shards_on_a_gloo_mesh_divide_by_the_kept_axes(runs, arch):
    """On the (2, 2) mesh every rank's ``distribute_tensor`` block of a
    parameter is its global shape divided by the spec's axes, and the
    expert slabs hold E/2 experts."""
    for r in runs["ranks"]:
        got = r[arch]
        slab = got.pop("slab")
        for path, (shape, spec, local) in got.items():
            want = list(shape)
            for d, entry in enumerate(spec):
                for _ in ((entry,) if isinstance(entry, str) else entry or ()):
                    want[d] //= 2
            assert tuple(want) == local, (arch, path, spec)
        assert any(s != (None,) * len(s) for _, s, _ in got.values())
        if arch == "dbrx-132b":
            assert slab[1] * 2 == jregistry.smoke_config(arch).n_experts


def test_constrain_redistributes_a_dtensor(runs):
    for r in runs["ranks"]:
        placements, local, same, plain, batch, model = r["constrain"]
        assert "Shard(dim=0)" in placements and local == (2, 8)
        assert same and plain and (batch, model) == (2, 2)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_production_meshes_have_the_reference_shapes(runs):
    assert runs["fake"]["pod"] == [[16, 16], ["data", "model"]]
    assert runs["fake"]["multi"] == [[2, 16, 16], ["pod", "data", "model"]]


def test_host_mesh_on_gloo_ranks(runs):
    for r in runs["ranks"]:
        assert r["host_mesh"] == ((2, 2), ("data", "model"))


def test_make_host_mesh_without_a_device_wants_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()


# ---------------------------------------------------------------------------
# input shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape):
    """Shapes and dtypes of every input leaf without a mesh (meta
    tensors), and ``applicable`` and ``shape_kind``."""
    cfg, jcfg = get_config(arch), jregistry.get_config(arch)
    got = _flat(input_specs(cfg, shape))
    want = {"/".join(str(p.key) for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                jinput_specs(jcfg, shape))[0]}
    assert set(got) == set(want)
    for k, leaf in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == leaf.shape, k
        assert str(got[k].dtype).split(".")[-1] == jnp.dtype(leaf.dtype).name
        assert not hasattr(got[k], "sharding")
    assert applicable(cfg, shape) == japplicable(jcfg, shape)
    assert shape_kind(shape) == JSHAPES[shape].kind
    assert SHAPES[shape].seq_len == JSHAPES[shape].seq_len
    assert SHAPES[shape].global_batch == JSHAPES[shape].global_batch


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_on_the_production_mesh_equal_the_reference(runs, arch,
                                                                shape):
    """The port's specs under the 256-rank fake world's production mesh
    equal the reference's under its 256-device production mesh."""
    key = f"{arch}|{shape}"
    assert runs["fake"]["specs"][key] == runs["jax"][key]


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base",
                                  "internvl2-76b"])
def test_make_batch_equals_the_reference(arch, monkeypatch):
    """On a cut train shape (both packages' SHAPES entry replaced): the
    same tokens and embeddings from the same numpy seed."""
    import repro.configs.shapes as jshapes
    import repro_torch.configs.shapes as tshapes
    monkeypatch.setitem(jshapes.SHAPES, "train_4k",
                        jshapes.Shape("train_4k", "train", 300, 2))
    monkeypatch.setitem(tshapes.SHAPES, "train_4k",
                        tshapes.Shape("train_4k", "train", 300, 2))
    got = make_batch(get_config(arch), "train_4k", seed=3, device="cpu")
    want = jmake_batch(jregistry.get_config(arch), "train_4k", seed=3)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k].astype(jnp.float32))
        np.testing.assert_array_equal(got[k].float().numpy(), w)
        assert str(got[k].dtype).split(".")[-1] == want[k].dtype.name


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

def test_pipeline_on_four_ranks_equals_the_reference(runs):
    """gpipe over 4 gloo ranks, 6 microbatches, 8 tanh layers: every
    rank returns the outputs, equal to the reference's pipeline on 4 host
    devices and to the sequential layers at fp32 1e-5."""
    ref = torch.from_numpy(runs["x"])
    for w in torch.from_numpy(runs["ws"]):
        ref = torch.tanh(ref @ w)
    for r in runs["ranks"]:
        got = r["pipeline"].numpy()
        np.testing.assert_allclose(got, runs["jax_pipeline"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-5, atol=1e-5)


def test_stage_split_blocks_the_layers():
    ws = torch.arange(8 * 2 * 2.0).reshape(8, 2, 2)
    got = stage_split({"w": ws}, 4)["w"]
    assert got.shape == (4, 2, 2, 2)
    assert torch.equal(got[1, 0], ws[2])
    with pytest.raises(ValueError, match="3 stages"):
        stage_split(ws, 3)
