"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16 experts top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]
Same numbers as ``repro.configs.dbrx_132b``; the full CONFIG (about 265 GB
in bf16) does not fit one card."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
    vocab=100352, head_dim=128,
    pattern=(("attn", "moe"),),
    n_experts=16, top_k=4,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="dbrx-132b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16,
    pattern=(("attn", "moe"),),
    n_experts=4, top_k=2,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
