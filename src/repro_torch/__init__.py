"""PyTorch/CUDA port of the input-aware auto-tuning system.

Laid out like the JAX package ``repro`` (the reference), which it never
imports.  Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``), where every hand-written kernel is replaced by its plain
PyTorch version so the port can be checked against the reference without a
GPU.

  device.py       device resolution (cuda by default, cpu on request)
  kernels/        hand-written Hopper kernels, their plain versions, dispatch
  core/           tuning spaces with Hopper legality, vendor-style heuristics
  tunedb/         the tuning-record store (same JSONL as the reference)
  models/         dense decoder LM (SmolLM family)
  serve/          continuous-batching engine, flash-decode attention
  configs/        model configurations
  weights.py      conversion of reference parameter trees
  launch/         command-line entry points
"""
