"""Parameter spaces with Hopper (sm_90a) legality.

Same declarative :class:`ParamSpace` as ``repro.core.space`` and the same
parameter and input names and semantics for all four spaces, but the
block sizes are the CTA tiles of the hand-written CUDA kernels
(``kernels/csrc/{gemm,conv,attention,ssd}.cu``), so their ranges and the
legality predicates follow the card, not the TPU's VMEM and lane tiling.

GEMM:

  bm, bn      CTA output tile; 256 threads as a 16x16 grid, each thread
              owns (bm/16) x (bn/16) outputs in registers
  bk          K-extent of one shared-memory stage
  k_unroll    sub-dots per stage (with acc32=0 each sub-dot is rounded to
              the IO dtype before it is added, as on the TPU)
  k_split     split-K partial outputs, materialized and reduced by ops.py
  order       CTA raster: 0 = n fastest (m-major), 1 = m fastest
  acc32       fp32 accumulator (1) or IO-dtype running sum (0)
  prefetch    shared-memory stages of the cp.async ring

Conv (SAME, stride 1, NHWC input, RSCK filter; implicit GEMM over
(N*P*Q) x K outputs, reduced over C*R*S):

  b_npq       output pixels per CTA tile (flattened n, p, q); same 16 x 16
              thread grid, each thread owns (b_npq/16) x (b_k/16) outputs
  b_k         output channels per CTA tile
  b_c         input channels of one (r, s) window's sub-dot
  rs_unroll   (r, s) windows one shared-memory stage holds
  c_split     split-C partial outputs, materialized and reduced by ops.py
  order       CTA raster: 0 = k fastest, 1 = npq fastest
  acc32       fp32 accumulator (1) or IO-dtype running sum rounded after
              every (r, s) window's sub-dot (0), as on the TPU
  prefetch    shared-memory stages of the cp.async ring

Attention (``kernels/csrc/attention.cu``; q (B, Hq, Lq, D), k/v (B, Hkv,
Lkv, D)):

  b_q         query rows per CTA; the same 16 x 16 thread grid, each thread
              owns (b_q/16) rows x (b_kv/16) scores of a KV block
  b_kv        KV rows per block of the online softmax (and per stage)
  acc32       kept as a name: m, l and the output accumulator are fp32
              whatever it says, as in the TPU kernel; fp32 IO needs it
  prefetch    shared-memory stages of the K/V cp.async ring

SSD chunk scan (``kernels/csrc/ssd.cu``; x (B, L, H, P), B/C (B, L, S)):

  chunk       time steps per chunk: the quadratic intra-chunk form, the
              (P x S) state carried across chunks
  b_heads     heads per CTA (they share the chunk's B and C stages)
  acc32       kept as a name: the state and every sum are fp32 whatever it
              says, as in the TPU kernel; fp32 IO needs it
  prefetch    shared-memory stages of the x/dt/B/C cp.async ring

The attention and SSD kernels' shared memory depends on the head dim (D;
P and S), so launchability for them is a function of the input too:
``FITS[space](cfg, inputs)`` answers for every space.
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
CONV_REG_OVERHEAD = 48          # conv adds the window and halo arithmetic

Config = Dict[str, int]


class ConfigRejected(AssertionError):
    """The correctness gate's verdict on a legal config whose kernel output
    misses the fp32 oracle (or its plain version) at a shape: the config is
    not in X(inputs) there, so it is neither labelled nor picked."""


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


CONV_PARAMS: Dict[str, Tuple[int, ...]] = {
    "b_npq": (16, 32, 64, 128),
    "b_k": (16, 32, 64, 128),
    "b_c": (8, 16, 32, 64),
    "rs_unroll": (1, 2, 4),
    "c_split": (1, 2, 4, 8, 16),
    "order": (0, 1),
    "acc32": (0, 1),
    "prefetch": (1, 2, 3),
}

CONV_INPUTS = ("N", "H", "W", "C", "K", "R", "S", "dtype_bits")


def conv_out_shape(inputs: Mapping[str, int]) -> Tuple[int, int]:
    """SAME-padded unit-stride output spatial shape (DeepBench convention)."""
    return inputs["H"], inputs["W"]


def conv_smem_bytes(cfg: Mapping[str, int], dtype_bits: int) -> int:
    """Dynamic shared memory of one CTA: ``prefetch`` stages of
    ``rs_unroll`` windows (input tile + filter tile each), plus the tile's
    (n, p, q) row table (three ints per output pixel)."""
    bpe = dtype_bits // 8
    window = cfg["b_npq"] * cfg["b_c"] + cfg["b_c"] * cfg["b_k"]
    return cfg["prefetch"] * cfg["rs_unroll"] * window * bpe \
        + 12 * cfg["b_npq"]


def conv_regs_per_thread(cfg: Mapping[str, int]) -> int:
    """Estimated registers, as for the GEMM: accumulators (doubled for the
    acc32=0 sub-dot), one input column and one filter row fragment."""
    tm, tn = cfg["b_npq"] // 16, cfg["b_k"] // 16
    acc = tm * tn * (1 if cfg["acc32"] else 2)
    return acc + tm + tn + CONV_REG_OVERHEAD


def conv_fits(cfg: Mapping[str, int], dtype_bits: int) -> bool:
    """Can the conv kernel launch this config at all (shape-independent)?"""
    if not CONV_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32):
        return False
    if conv_smem_bytes(cfg, dtype_bits) > SMEM_PER_BLOCK:
        return False
    if conv_regs_per_thread(cfg) > MAX_REGS_PER_THREAD:
        return False
    if dtype_bits == 32 and not cfg["acc32"]:
        return False
    return True


def conv_is_legal(cfg: Mapping[str, int], inputs: Mapping[str, int]) -> bool:
    """Launchable, and no tile, split or unroll larger than the problem."""
    if not conv_fits(cfg, inputs["dtype_bits"]):
        return False
    P, Q = conv_out_shape(inputs)
    npq = inputs["N"] * P * Q
    C, K = inputs["C"], inputs["K"]
    if cfg["c_split"] > _ceil_div(C, cfg["b_c"]):
        return False
    if cfg["rs_unroll"] > inputs["R"] * inputs["S"]:
        return False
    if cfg["b_npq"] > _round_up(npq, 16) or cfg["b_k"] > _round_up(K, 16) \
            or cfg["b_c"] > _round_up(C, 8):
        return False
    return True


CONV_SPACE = ParamSpace(
    name="conv",
    params=CONV_PARAMS,
    input_params=CONV_INPUTS,
    is_legal=conv_is_legal,
)

# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

ATTENTION_PARAMS: Dict[str, Tuple[int, ...]] = {
    "b_q": (16, 32, 64, 128),
    "b_kv": (16, 32, 64, 128),
    "acc32": (0, 1),
    "prefetch": (1, 2, 3),
}

ATTENTION_INPUTS = ("B", "Hq", "Hkv", "Lq", "Lkv", "D", "dtype_bits", "causal")
ATTN_REG_OVERHEAD = 40          # addressing, loop and mask registers


def attention_smem_bytes(cfg: Mapping[str, int], dtype_bits: int, D: int
                         ) -> int:
    """Dynamic shared memory of one CTA, as ``attention.cu`` lays it out:
    the Q tile and ``prefetch`` stages of K and V tiles (rows of D plus
    16 bytes against bank conflicts), the fp32 P tile (``b_q`` x (``b_kv``
    + 4)) and the fp32 output accumulator (rows of D rounded up to 32,
    plus 16)."""
    bpe = dtype_bits // 8
    row = D * bpe + 16
    tiles = (cfg["b_q"] + 2 * cfg["prefetch"] * cfg["b_kv"]) * row
    return tiles + cfg["b_q"] * (cfg["b_kv"] + 4) * 4 \
        + cfg["b_q"] * (_round_up(D, 32) + 16) * 4


def attention_regs_per_thread(cfg: Mapping[str, int], dtype_bits: int
                              ) -> int:
    """Estimated registers: the thread's scores, one 16-byte K vector per
    score column and one Q vector (as floats), four output columns per row
    of P.V, the row's m, l and alpha, plus overhead."""
    tq, tk = cfg["b_q"] // 16, cfg["b_kv"] // 16
    vec = 128 // dtype_bits
    return tq * tk + tk * vec + vec + 4 * tq + 3 * tq + ATTN_REG_OVERHEAD


def attention_fits(cfg: Mapping[str, int], dtype_bits: int, D: int) -> bool:
    """Can the attention kernel launch this config at head dim ``D``?  D
    must be a multiple of 8: the kernel reads rows in 16-byte pieces."""
    if not ATTENTION_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32) or D % 8:
        return False
    if attention_smem_bytes(cfg, dtype_bits, D) > SMEM_PER_BLOCK:
        return False
    if attention_regs_per_thread(cfg, dtype_bits) > MAX_REGS_PER_THREAD:
        return False
    if dtype_bits == 32 and not cfg["acc32"]:
        return False
    return True


def attention_is_legal(cfg: Mapping[str, int], inputs: Mapping[str, int]
                       ) -> bool:
    """Launchable at this head dim, and no tile larger than the problem
    (rounded up to 16 rows: a decode step's single query row takes
    ``b_q=16``)."""
    if not attention_fits(cfg, inputs["dtype_bits"], inputs["D"]):
        return False
    return cfg["b_q"] <= _round_up(inputs["Lq"], 16) \
        and cfg["b_kv"] <= _round_up(inputs["Lkv"], 16)


ATTENTION_SPACE = ParamSpace(
    name="attention",
    params=ATTENTION_PARAMS,
    input_params=ATTENTION_INPUTS,
    is_legal=attention_is_legal,
)


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk scan
# ---------------------------------------------------------------------------

SSD_PARAMS: Dict[str, Tuple[int, ...]] = {
    "chunk": (16, 32, 64, 128, 256),
    "b_heads": (1, 2, 4, 8),
    "acc32": (0, 1),
    "prefetch": (1, 2, 3),
}

SSD_INPUTS = ("B", "L", "H", "P", "S", "dtype_bits")   # P=head dim, S=state dim
SSD_ROW_TILE = 16       # chunk rows whose scores the kernel holds at once


def ssd_smem_bytes(cfg: Mapping[str, int], dtype_bits: int, P: int, S: int
                   ) -> int:
    """Dynamic shared memory of one CTA, as ``ssd.cu`` lays it out:
    ``prefetch`` stages of the chunk's x (``b_heads`` x P per step), dt,
    and B and C rows (S plus 16 bytes each); the fp32 state (``b_heads``
    x S x P); one tile of :data:`SSD_ROW_TILE` score rows (fp32, chunk + 4
    wide: the chunk x chunk scores are never held whole); the per-head
    cumulative decays and state weights."""
    bpe = dtype_bits // 8
    c, bh = cfg["chunk"], cfg["b_heads"]
    stage = c * bh * P * bpe + _round_up(c * bh * bpe, 16) \
        + 2 * c * (S * bpe + 16)
    return cfg["prefetch"] * stage + bh * S * P * 4 \
        + SSD_ROW_TILE * (c + 4) * 4 + 2 * bh * c * 4


def ssd_fits(cfg: Mapping[str, int], dtype_bits: int, P: int, S: int) -> bool:
    """Can the SSD kernel launch this config at head dim P, state dim S?
    Both must be multiples of 8: the kernel reads rows in 16-byte pieces."""
    if not SSD_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32) or P % 8 or S % 8:
        return False
    if ssd_smem_bytes(cfg, dtype_bits, P, S) > SMEM_PER_BLOCK:
        return False
    if dtype_bits == 32 and not cfg["acc32"]:
        return False
    return True


def ssd_is_legal(cfg: Mapping[str, int], inputs: Mapping[str, int]) -> bool:
    """Launchable at these P and S, no chunk longer than the sequence
    (rounded up to 16), and a head block that divides H."""
    if not ssd_fits(cfg, inputs["dtype_bits"], inputs["P"], inputs["S"]):
        return False
    return cfg["chunk"] <= _round_up(inputs["L"], 16) \
        and inputs["H"] % cfg["b_heads"] == 0


SSD_SPACE = ParamSpace(
    name="ssd",
    params=SSD_PARAMS,
    input_params=SSD_INPUTS,
    is_legal=ssd_is_legal,
)

SPACES: Dict[str, ParamSpace] = {"gemm": GEMM_SPACE, "conv": CONV_SPACE,
                                 "attention": ATTENTION_SPACE,
                                 "ssd": SSD_SPACE}

# per space: can the kernel launch this config at this input (its dtype;
# for attention and SSD also the head and state dims)?
FITS: Dict[str, Callable[[Mapping[str, int], Mapping[str, int]], bool]] = {
    "gemm": lambda cfg, x: gemm_fits(cfg, x["dtype_bits"]),
    "conv": lambda cfg, x: conv_fits(cfg, x["dtype_bits"]),
    "attention": lambda cfg, x: attention_fits(cfg, x["dtype_bits"], x["D"]),
    "ssd": lambda cfg, x: ssd_fits(cfg, x["dtype_bits"], x["P"], x["S"]),
}


def gemm_input(M: int, N: int, K: int, dtype_bits: int = 16,
               trans_a: bool = False, trans_b: bool = False) -> Dict[str, int]:
    return {"M": int(M), "N": int(N), "K": int(K), "dtype_bits": int(dtype_bits),
            "trans_a": int(trans_a), "trans_b": int(trans_b)}


def conv_input(N: int, H: int, W: int, C: int, K: int, R: int, S: int,
               dtype_bits: int = 16) -> Dict[str, int]:
    return {"N": int(N), "H": int(H), "W": int(W), "C": int(C), "K": int(K),
            "R": int(R), "S": int(S), "dtype_bits": int(dtype_bits)}


def attention_input(B: int, Hq: int, Hkv: int, Lq: int, Lkv: int, D: int,
                    dtype_bits: int = 16, causal: bool = True
                    ) -> Dict[str, int]:
    return {"B": int(B), "Hq": int(Hq), "Hkv": int(Hkv), "Lq": int(Lq),
            "Lkv": int(Lkv), "D": int(D), "dtype_bits": int(dtype_bits),
            "causal": int(causal)}


def ssd_input(B: int, L: int, H: int, P: int, S: int, dtype_bits: int = 16
              ) -> Dict[str, int]:
    return {"B": int(B), "L": int(L), "H": int(H), "P": int(P), "S": int(S),
            "dtype_bits": int(dtype_bits)}
