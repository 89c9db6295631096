"""Tuning spaces, baselines and the offline tuning loop of the port (paper
§3-§7).

  space.py        ParamSpace + the GEMM, conv, attention and SSD spaces with
                  Hopper legality
  heuristics.py   vendor-style fixed menus + size-bucket selection
  features.py     log2 featurizer (a copy of the reference's)
  generative.py   factorized categorical sampler, workload draws (a copy)
  backend.py      CudaEventBackend (times the kernels), CheckedBackend
  dataset.py      labelled training sets
  mlp.py          the torch MLP regressor (reference npz weights)
  search.py       §6 exhaustive search with top-k re-measurement
  tuner.py        InputAwareTuner
"""
