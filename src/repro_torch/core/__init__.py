"""Tuning spaces and baselines of the port (paper §3, §2/7).

  space.py        ParamSpace + the GEMM space with Hopper legality
  heuristics.py   vendor-style fixed menu + size-bucket selection
"""
