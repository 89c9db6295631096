"""Kernels of the port: hand-written CUDA for sm_90a, each beside its plain
PyTorch version.

  csrc/gemm.cu  parameterised GEMM (replaces repro.kernels.matmul)
  csrc/conv.cu  SAME/stride-1 implicit-GEMM conv (replaces repro.kernels.conv)
  csrc/attention.cu  flash attention (replaces repro.kernels.attention)
  csrc/ssd.cu   Mamba-2 SSD chunk scan (replaces repro.kernels.ssd)
  _build.py     nvcc build at first use (or in parallel) + ctypes binding
  matmul.py     GEMM wrapper (launch counter) and matmul_plain
  conv.py       conv wrapper (launch counter) and conv2d_plain
  attention.py  attention wrapper (launch counter) and attention_plain
  ssd.py        SSD wrapper (launch counter) and ssd_plain
  ops.py        entry points: config defaults, block shrinking, split-K /
                split-C reduction
  ref.py        fp32 oracles
  dispatch.py   tuned-config routing: tuner -> exact -> nearest ->
                heuristics (GEMM, conv) or ops defaults (attention, SSD);
                the tuner's correctness gate (check_config)
"""
