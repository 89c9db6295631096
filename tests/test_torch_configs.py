"""The port's configs against the reference's, field for field, and the
dense ones and the vision-frontend one (internvl2-76b, on tokens, as the
JAX engine serves it) served at SMOKE against the JAX engine (the MoE
family's are served in tests/test_torch_moe.py; whisper-base is not served
by either engine, tests/test_torch_encdec.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.models import init_params as jinit_params
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.models import ModelConfig
from repro_torch.serve import Engine as TEngine
from repro_torch.serve import ServeConfig as TServeConfig
from repro_torch.weights import params_from_jax

DENSE = ("qwen3-14b", "glm4-9b", "llama3-405b")
MOE = ("arctic-480b", "dbrx-132b", "jamba-v0.1-52b")
ENCDEC, FRONTEND = ("whisper-base",), ("internvl2-76b",)
ALL = ("smollm-135m", "mamba2-1.3b", *DENSE, *MOE, *ENCDEC, *FRONTEND)


def test_the_registry_holds_the_ported_archs():
    assert set(ARCH_NAMES) == set(ALL)
    assert set(ARCH_NAMES) == set(jregistry.ARCH_NAMES)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(ALL))
def test_config_equals_the_reference(arch, smoke):
    """Every field of the port's ModelConfig equals the reference's (the
    dtype by name), the training fields (remat, logit_chunk,
    causal_block_skip) and the mesh path's moe_a2a among them; only the
    reference's unroll_scan, mlp_tp and decode_replicate_acts have no
    counterpart in the port."""
    got = smoke_config(arch) if smoke else get_config(arch)
    want = (jregistry.smoke_config(arch) if smoke
            else jregistry.get_config(arch))
    for f in dataclasses.fields(ModelConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "dtype":
            assert str(g).split(".")[-1] == jnp.dtype(w).name, arch
        else:
            assert g == w, (arch, f.name, g, w)
    got.check_supported()


@pytest.mark.parametrize("arch", DENSE + FRONTEND)
def test_dense_smoke_serves_the_jax_engine_tokens(arch):
    jcfg, tcfg = jregistry.smoke_config(arch), smoke_config(arch)
    jp = jinit_params(jcfg, jax.random.PRNGKey(2))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab, n) for n in (6, 11, 3, 9)]
    jout = JEngine(jcfg, jp, JServeConfig(max_len=48, slots=3)).generate(
        prompts, max_new=6)
    eng = TEngine(tcfg, tp, TServeConfig(max_len=48, slots=3), device="cpu")
    tout = eng.generate(prompts, max_new=6)
    assert tout == [[int(t) for t in o] for o in jout]
    assert all(len(o) == 6 for o in tout)


@pytest.mark.parametrize("change,err", [
    ({"pattern": (("conv", "dense"),)}, NotImplementedError),
    ({"pattern": (("attn", "glu"),)}, NotImplementedError),
    ({"frontend": "video"}, NotImplementedError),
    ({"frontend": "audio"}, NotImplementedError),          # no encoder
    ({"encoder_layers": 2, "frontend": "vision"}, NotImplementedError),
    ({"tie_embeddings": False}, NotImplementedError),
])
def test_check_supported_still_raises_on_what_is_not_ported(change, err):
    """Every family of the reference is ported; check_supported still
    refuses an unknown mixer or MLP, an unknown frontend, an audio
    frontend without an encoder (or an encoder behind another frontend)
    and untied embeddings."""
    cfg = dataclasses.replace(smoke_config("internvl2-76b"), **change)
    with pytest.raises(err):
        cfg.check_supported()
