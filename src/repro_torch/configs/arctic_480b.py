"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 PLUS a dense residual MLP in parallel.
[hf:Snowflake/snowflake-arctic-base; hf]  Same numbers as
``repro.configs.arctic_480b``; the full CONFIG does not fit one card."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    pattern=(("attn", "moe+dense"),),
    n_experts=128, top_k=2,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="arctic-480b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96,
    vocab=512, head_dim=16,
    pattern=(("attn", "moe+dense"),),
    n_experts=8, top_k=2,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
