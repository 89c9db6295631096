"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936, qk_norm.  [hf:Qwen/Qwen3-8B]  Same numbers as
``repro.configs.qwen3_14b``."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    n_layers=40, d_model=5120, n_heads=40, n_kv=8, d_ff=17408,
    vocab=151936, head_dim=128,
    qk_norm=True,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="qwen3-14b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, qk_norm=True,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
