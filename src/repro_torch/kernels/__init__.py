"""Kernels of the port: hand-written CUDA for sm_90a, each beside its plain
PyTorch version.

  csrc/gemm.cu  parameterised GEMM (replaces repro.kernels.matmul)
  _build.py     nvcc build at first use + ctypes binding
  matmul.py     GEMM wrapper (launch counter) and matmul_plain
  ops.py        GEMM entry point: config defaults, block shrinking, split-K
                reduction
  ref.py        fp32 oracles
  dispatch.py   tuned-config routing: exact -> nearest -> heuristics
"""
