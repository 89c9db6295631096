"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The InternViT frontend is a stub: the caller supplies
precomputed patch embeddings, prepended to the token sequence; the config
is the InternLM2/LLaMA-style language backbone.  [arXiv:2404.16821]  Same
numbers as ``repro.configs.internvl2_76b``; the full CONFIG (about 139 GB
in bf16) does not fit one card."""

import torch

from repro_torch.models import ModelConfig

N_PATCHES = 256        # stub ViT output tokens per example

CONFIG = ModelConfig(
    name="internvl2-76b",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=28672,
    vocab=128256, head_dim=128,
    frontend="vision", n_frontend_tokens=N_PATCHES,
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="internvl2-76b-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16,
    frontend="vision", n_frontend_tokens=8,
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
