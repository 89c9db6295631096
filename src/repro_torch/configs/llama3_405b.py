"""llama3-405b [dense] — 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  GQA, 128k vocab.  [arXiv:2407.21783]  Same numbers as
``repro.configs.llama3_405b``; the full CONFIG does not fit one card."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    n_layers=126, d_model=16384, n_heads=128, n_kv=8, d_ff=53248,
    vocab=128256, head_dim=128,
    rope_theta=5e5,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="llama3-405b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=192,
    vocab=512, head_dim=16, rope_theta=5e5,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
