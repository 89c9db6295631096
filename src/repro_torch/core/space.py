"""Parameter spaces with Hopper (sm_90a) legality.

Same declarative :class:`ParamSpace` as ``repro.core.space`` and the same
GEMM parameter names and semantics (``k_split``, ``order``, ``acc32``,
``k_unroll``, ``prefetch``), but the block sizes are the CTA tile of the
hand-written CUDA kernel (``kernels/csrc/gemm.cu``), so their ranges and the
legality predicate follow the card, not the TPU's VMEM and lane tiling:

  bm, bn      CTA output tile; 256 threads as a 16x16 grid, each thread
              owns (bm/16) x (bn/16) outputs in registers
  bk          K-extent of one shared-memory stage
  k_unroll    sub-dots per stage (with acc32=0 each sub-dot is rounded to
              the IO dtype before it is added, as on the TPU)
  k_split     split-K partial outputs, materialized and reduced by ops.py
  order       CTA raster: 0 = n fastest (m-major), 1 = m fastest
  acc32       fp32 accumulator (1) or IO-dtype running sum (0)
  prefetch    shared-memory stages of the cp.async ring
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

# ---------------------------------------------------------------------------
# H100 (sm_90a) limits for one thread block
# ---------------------------------------------------------------------------
SMEM_PER_BLOCK = 232_448        # max dynamic shared memory (after opt-in)
SMEM_DEFAULT = 48 * 1024        # above this the launcher opts in
# the kernel always runs 256 threads (16 x 16), so a thread may hold up to
# 255 registers and the block still fits the SM's 65,536
MAX_REGS_PER_THREAD = 255
GEMM_REG_OVERHEAD = 40          # addressing / loop registers, estimated

Config = Dict[str, int]


@dataclasses.dataclass(frozen=True)
class ParamSpace:
    """Declarative tuning-parameter space with a legality predicate."""

    name: str
    params: Mapping[str, Tuple[int, ...]]
    input_params: Tuple[str, ...]
    is_legal: Callable[[Mapping[str, int], Mapping[str, int]], bool]

    @property
    def param_names(self) -> Tuple[str, ...]:
        return tuple(self.params.keys())

    def enumerate(self) -> Iterable[Config]:
        names = self.param_names
        for combo in itertools.product(*(self.params[n] for n in names)):
            yield dict(zip(names, combo))

    def enumerate_legal(self, inputs: Mapping[str, int]) -> List[Config]:
        return [c for c in self.enumerate() if self.is_legal(c, inputs)]

    def contains(self, cfg: Mapping[str, int]) -> bool:
        return all(cfg.get(k) in v for k, v in self.params.items())


GEMM_PARAMS: Dict[str, Tuple[int, ...]] = {
    "bm": (16, 32, 64, 128),
    "bn": (32, 64, 128),
    "bk": (32, 64, 128, 256),
    "k_unroll": (1, 2, 4),
    "k_split": (1, 2, 4, 8),
    "order": (0, 1),
    "acc32": (0, 1),
    "prefetch": (1, 2, 3),
}

GEMM_INPUTS = ("M", "N", "K", "dtype_bits", "trans_a", "trans_b")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _ceil_div(a, b) * b


def gemm_smem_bytes(cfg: Mapping[str, int], dtype_bits: int) -> int:
    """Dynamic shared memory of one CTA: ``prefetch`` stages of A and B."""
    bpe = dtype_bits // 8
    return cfg["prefetch"] * (cfg["bm"] * cfg["bk"]
                              + cfg["bk"] * cfg["bn"]) * bpe


def gemm_regs_per_thread(cfg: Mapping[str, int]) -> int:
    """Estimated registers: fp32 accumulators (doubled for the acc32=0
    sub-dot), one A column and one B row fragment, plus overhead."""
    tm, tn = cfg["bm"] // 16, cfg["bn"] // 16
    acc = tm * tn * (1 if cfg["acc32"] else 2)
    return acc + tm + tn + GEMM_REG_OVERHEAD


def gemm_fits(cfg: Mapping[str, int], dtype_bits: int) -> bool:
    """Can the kernel launch this config at all (shape-independent)?"""
    if not GEMM_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32):
        return False
    if gemm_smem_bytes(cfg, dtype_bits) > SMEM_PER_BLOCK:
        return False
    if gemm_regs_per_thread(cfg) > MAX_REGS_PER_THREAD:
        return False
    # sub-dots are whole 16-element slices of a stage
    if cfg["bk"] % (cfg["k_unroll"] * 16):
        return False
    # fp32 IO is full fp32 FMA with an fp32 accumulator
    if dtype_bits == 32 and not cfg["acc32"]:
        return False
    return True


def gemm_is_legal(cfg: Mapping[str, int], inputs: Mapping[str, int]) -> bool:
    """Membership in X for one input: launchable, and no tile or split
    larger than the problem it covers."""
    if not gemm_fits(cfg, inputs["dtype_bits"]):
        return False
    M, N, K = inputs["M"], inputs["N"], inputs["K"]
    if cfg["k_split"] > _ceil_div(K, cfg["bk"]):
        return False
    if cfg["bm"] > _round_up(M, 16) or cfg["bn"] > _round_up(N, 32) \
            or cfg["bk"] > _round_up(K, 32):
        return False
    return True


GEMM_SPACE = ParamSpace(
    name="gemm",
    params=GEMM_PARAMS,
    input_params=GEMM_INPUTS,
    is_legal=gemm_is_legal,
)

SPACES: Dict[str, ParamSpace] = {"gemm": GEMM_SPACE}


def gemm_input(M: int, N: int, K: int, dtype_bits: int = 16,
               trans_a: bool = False, trans_b: bool = False) -> Dict[str, int]:
    return {"M": int(M), "N": int(N), "K": int(K), "dtype_bits": int(dtype_bits),
            "trans_a": int(trans_a), "trans_b": int(trans_b)}
