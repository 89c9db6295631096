"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
[hf:HuggingFaceTB/SmolLM-135M]  Same numbers as ``repro.configs.smollm_135m``."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536,
    vocab=49152, head_dim=64,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="smollm-135m-smoke",
    n_layers=2, d_model=72, n_heads=3, n_kv=1, d_ff=192,
    vocab=512, head_dim=24,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
