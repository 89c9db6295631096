"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
Encoder-decoder; the conv/mel frontend is a stub: the caller supplies
precomputed frame embeddings (1500 frames = 30 s) to the encoder.  The
decoder self-attends causally and cross-attends into the encoder output.
[arXiv:2212.04356; unverified]  Same numbers as
``repro.configs.whisper_base``."""

import torch

from repro_torch.models import ModelConfig

ENCODER_FRAMES = 1500

CONFIG = ModelConfig(
    name="whisper-base",
    n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048,
    vocab=51865, head_dim=64,
    encoder_layers=6, encoder_len=ENCODER_FRAMES,
    frontend="audio",
    dtype=torch.bfloat16,
    decode_kv_splits=16,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, head_dim=16,
    encoder_layers=2, encoder_len=16, frontend="audio",
    dtype=torch.float32, attn_chunk=64, logit_chunk=64,
)
