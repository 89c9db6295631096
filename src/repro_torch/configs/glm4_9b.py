"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552.  RoPE, extreme GQA (kv=2).  [hf:THUDM/glm-4-9b]  Same numbers
as ``repro.configs.glm4_9b``."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    n_layers=40, d_model=4096, n_heads=32, n_kv=2, d_ff=13696,
    vocab=151552, head_dim=128,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="glm4-9b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, d_ff=128,
    vocab=512, head_dim=16,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
