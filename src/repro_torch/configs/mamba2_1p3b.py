"""mamba2-1.3b [ssm] — 48L d_model=2048, attention-free, vocab=50280,
ssm_state=128.  SSD (state-space duality): chunked matmul form in prefill,
O(1) recurrence in decode.  [arXiv:2405.21060]  Same numbers as
``repro.configs.mamba2_1p3b``."""

import torch

from repro_torch.models import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=0, n_kv=0, d_ff=0,
    vocab=50280,
    pattern=(("mamba", "none"),),
    ssm_state=128, ssm_head_dim=64,
    dtype=torch.bfloat16,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv=0, d_ff=0,
    vocab=512,
    pattern=(("mamba", "none"),),
    ssm_state=16, ssm_head_dim=16,
    dtype=torch.float32, ssd_chunk=32, logit_chunk=64,
)
