"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16 experts top-2.  Mamba:attention 1:7 interleave (one
attention layer per 8-layer period), MoE every other layer.
Adaptation note (DESIGN.md): Jamba v0.1 uses a Mamba-1 mixer (d_state=16);
we use our SSD (Mamba-2) mixer with state=128 so the hybrid shares the
tuned SSD kernel — same 1:7 structure, same attention/MoE placement.
[arXiv:2403.19887; hf]  Same numbers as ``repro.configs.jamba_v01_52b``;
the full CONFIG does not fit one card."""

import torch

from repro_torch.models import ModelConfig

# 8-layer period, repeated 4x: attention at position 3 (1:7), MoE every
# other layer (positions 0, 2, 4, 6).
PERIOD = (
    ("mamba", "moe"), ("mamba", "dense"),
    ("mamba", "moe"), ("attn", "dense"),
    ("mamba", "moe"), ("mamba", "dense"),
    ("mamba", "moe"), ("mamba", "dense"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=65536, head_dim=128,
    pattern=PERIOD,
    n_experts=16, top_k=2,
    ssm_state=128, ssm_head_dim=64,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16,
    pattern=PERIOD,
    n_experts=4, top_k=2,
    ssm_state=16, ssm_head_dim=16,
    dtype=torch.float32, ssd_chunk=32, attn_chunk=64, logit_chunk=64,
)
