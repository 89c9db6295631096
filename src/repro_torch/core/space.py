"""Parameter spaces with Hopper (sm_90a) legality.

Same declarative :class:`ParamSpace` as ``repro.core.space`` and the same
parameter and input names and semantics for all four spaces, but the
block sizes are the CTA tiles of the hand-written CUDA kernels
(``kernels/csrc/{gemm,conv,attention,ssd}.cu``), so their ranges and the
legality predicates follow the card, not the TPU's VMEM and lane tiling.

GEMM:

  bm, bn      CTA output tile.  bf16: warps sized to the tile, each on a
              min(bm, 32) x (bn, or bn/2 from 64 up) block of mma.sync
              fragments (1 warp at 16 x 32, 8 at 128 x 128), stage rows
              padded for ldmatrix (:func:`mma_pitch`).  fp32: the 16 x 16
              CUDA-core thread grid, each thread (bm/16) x (bn/16) outputs
  bk          K-extent of one shared-memory stage
  k_unroll    sub-dots per stage (with acc32=0 each sub-dot is rounded to
              the IO dtype before it is added, as on the TPU)
  k_split     split-K partial outputs, materialized by the kernel and
              summed by one reduction pass (``matmul.splitk_reduce``)
  order       CTA raster: 0 = n fastest (m-major), 1 = m fastest
  acc32       fp32 accumulator (1) or IO-dtype running sum (0)
  prefetch    shared-memory stages of the cp.async ring

Conv (SAME, stride 1, NHWC input, RSCK filter; implicit GEMM over
(N*P*Q) x K outputs, reduced over C*R*S):

  b_npq       output pixels per CTA tile (flattened n, p, q).  bf16: warps
              sized to the tile, each on a min(b_npq, 32) x (b_k, or b_k/2
              from 64 up) block of mma.sync fragments (1 warp at 16 x 16,
              8 at 128 x 128).  fp32: the 16 x 16 CUDA-core thread grid,
              each thread (b_npq/16) x (b_k/16) outputs
  b_k         output channels per CTA tile
  b_c         input channels of one (r, s) window's sub-dot
  rs_unroll   (r, s) windows one shared-memory stage holds
  c_split     split-C partial outputs, materialized and reduced by ops.py
  order       CTA raster: 0 = k fastest, 1 = npq fastest
  acc32       fp32 accumulator (1) or IO-dtype running sum rounded after
              every (r, s) window's sub-dot (0), as on the TPU
  prefetch    shared-memory stages of the cp.async ring

Attention (``kernels/csrc/attention.cu``; q (B, Hq, Lq, D), k/v (B, Hkv,
Lkv, D); a CTA owns one (b, KV head) and its group = Hq/Hkv query heads'
rows packed head-major, group*Lq of them):

  b_q         packed query rows per CTA.  bf16: one warp per 16 rows on
              mma.sync tensor cores; a CTA of fewer than 4 row tiles gives
              each tile cs = min(4 / (b_q/16), b_kv/16) warps, each on a
              disjoint b_kv/cs-column slice of every KV block.  fp32: the
              16 x 16 CUDA-core thread grid, each thread (b_q/16) rows x
              (b_kv/16) scores of a KV block
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
# every kernel's CTA runs at most 256 threads (the fp32 bodies' 16 x 16
# grid; the bf16 GEMM, conv and attention bodies size their warps to the
# tile, 1 to 8 warps), so a thread may hold up to 255 registers and
# the block still fits the SM's 65,536
MAX_REGS_PER_THREAD = 255
# GEMM (both bodies): addressing, loop and load registers; fitted to the
# ptxas -v report so that the estimate equals it at the 128 x 128 tile
# (bf16 156 registers, 224 with acc32=0; fp32 128).  It bounds every bf16
# instantiation but the one- and two-warp 16 x 32 and 16 x 64 tiles (122
# to 128 registers, up to 24 above it); the fp32 bodies use 60 to 128.  No
# GEMM kernel comes near the 255 a thread may hold, so the estimate
# refuses nothing the kernels could run; chip_smoke.py's build phase holds
# every kernel a legal config launches to no spills.
GEMM_REG_OVERHEAD = 48
GEMM_MMA_REG_OVERHEAD = 80
# conv (both bodies): addressing, the window and halo arithmetic and, in
# bf16, the rounding temporaries; fitted to the ptxas -v report so that the
# estimate bounds every instantiation and equals it at the 128 x 128 tile
# (fp32 165 registers; bf16 164, and 228 with acc32=0)
CONV_REG_OVERHEAD = 85
CONV_MMA_REG_OVERHEAD = 88

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


def mma_pitch(n: int) -> int:
    """Row pitch (elements) of a bf16 stage row of ``n`` elements in the
    mma.sync bodies: an odd number of 16-byte units, so an ldmatrix phase's
    eight rows hit distinct banks (``mma_pitch`` in ``csrc/mma.cuh``)."""
    return n if (n // 8) % 2 else n + 8


def mma_warp_tile(rows: int, cols: int) -> Tuple[int, int]:
    """(rows, columns) of the output block one warp of a bf16 mma.sync body
    owns in a ``rows`` x ``cols`` CTA tile (``MmaTile`` in
    ``csrc/mma.cuh``)."""
    return min(rows, 32), cols if cols < 64 else cols // 2


def gemm_smem_bytes(cfg: Mapping[str, int], dtype_bits: int) -> int:
    """Dynamic shared memory of one CTA: ``prefetch`` stages of the A
    (bm x bk) and B (bk x bn) tiles; bf16 rows padded by
    :func:`mma_pitch`."""
    bpe = dtype_bits // 8
    bk, bn = cfg["bk"], cfg["bn"]
    pa, pb = (mma_pitch(bk), mma_pitch(bn)) if dtype_bits == 16 else (bk, bn)
    return cfg["prefetch"] * (cfg["bm"] * pa + bk * pb) * bpe


def gemm_regs_per_thread(cfg: Mapping[str, int], dtype_bits: int) -> int:
    """Estimated registers.  bf16: the warp block's fp32 accumulator
    fragments (doubled, and 4 rounding temporaries, for the acc32=0
    sub-dot), the A fragments of one k-step and one B pair, plus overhead.
    fp32: accumulators, one A column and one B row fragment, plus
    overhead."""
    if dtype_bits == 16:
        wm, wn = mma_warp_tile(cfg["bm"], cfg["bn"])
        acc = wm * wn // 32 * (1 if cfg["acc32"] else 2)
        rounding = 0 if cfg["acc32"] else 4
        return acc + rounding + wm // 16 * 4 + 4 + GEMM_MMA_REG_OVERHEAD
    tm, tn = cfg["bm"] // 16, cfg["bn"] // 16
    return tm * tn + tm + tn + GEMM_REG_OVERHEAD


def gemm_fits(cfg: Mapping[str, int], dtype_bits: int) -> bool:
    """Can the kernel launch this config at all (shape-independent)?"""
    if not GEMM_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32):
        return False
    if gemm_smem_bytes(cfg, dtype_bits) > SMEM_PER_BLOCK:
        return False
    if gemm_regs_per_thread(cfg, dtype_bits) > MAX_REGS_PER_THREAD:
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
    ``rs_unroll`` windows (input tile + filter tile each; bf16 rows padded
    by :func:`mma_pitch`), plus the tile's row table (p, q and a
    64-bit offset per output pixel: 16 bytes)."""
    bpe = dtype_bits // 8
    b_c, b_k = cfg["b_c"], cfg["b_k"]
    if dtype_bits == 16:
        pa, pf = mma_pitch(b_c), mma_pitch(b_k)
    else:
        pa, pf = b_c, b_k
    window = cfg["b_npq"] * pa + b_c * pf
    return cfg["prefetch"] * cfg["rs_unroll"] * window * bpe \
        + 16 * cfg["b_npq"]


def conv_regs_per_thread(cfg: Mapping[str, int], dtype_bits: int) -> int:
    """Estimated registers.  bf16: the warp block's fp32 accumulator
    fragments (doubled for the acc32=0 sub-dot), the A fragments of one
    k-step and one B pair, plus overhead.  fp32, as for the GEMM:
    accumulators (doubled for acc32=0), one input column and one filter
    row fragment."""
    if dtype_bits == 16:
        wm, wn = mma_warp_tile(cfg["b_npq"], cfg["b_k"])
        acc = wm * wn // 32 * (1 if cfg["acc32"] else 2)
        return acc + wm // 16 * 4 + 4 + CONV_MMA_REG_OVERHEAD
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
    if conv_regs_per_thread(cfg, dtype_bits) > MAX_REGS_PER_THREAD:
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
ATTN_REG_OVERHEAD = 40          # fp32 body: addressing, loop and mask
# bf16 body: addressing, masks and the merge, fitted to the ptxas -v report
# so that exactly the spilling instantiations exceed 255
ATTN_MMA_REG_OVERHEAD = 64
ATTN_HEAD_TILES = (64, 128, 256)  # the bf16 body's compile-time head dims
ATTN_MMA_WARPS = 4              # warps a CTA of few row tiles fills up to


def attention_head_tile(D: int) -> int:
    """The bf16 kernel's head-dim bucket: D is zero-padded up to it."""
    for tile in ATTN_HEAD_TILES:
        if D <= tile:
            return tile
    raise ValueError(f"bf16 attention takes D <= {ATTN_HEAD_TILES[-1]}, "
                     f"got {D}")


def attention_warps(cfg: Mapping[str, int]) -> Tuple[int, int]:
    """(row tiles, warps per row tile) of a bf16 CTA: one warp per 16
    packed rows; where that gives fewer than 4 warps, each row tile takes
    up to 4 / tiles warps, each on a slice of at least 16 KV columns."""
    tiles = cfg["b_q"] // 16
    if tiles >= ATTN_MMA_WARPS:
        return tiles, 1
    return tiles, min(ATTN_MMA_WARPS // tiles, cfg["b_kv"] // 16)


def attention_smem_bytes(cfg: Mapping[str, int], dtype_bits: int, D: int
                         ) -> int:
    """Dynamic shared memory of one CTA, as ``attention.cu`` lays it out.

    bf16: the Q tile and ``prefetch`` stages of K and V tiles, rows of the
    head tile plus 16 bytes against bank conflicts (P and the accumulator
    live in registers); where warps split the columns, their merge (fp32
    m, l and a 16 x (tile + 4) accumulator per warp) reuses the ring,
    grown to hold it where one narrow stage is smaller.  fp32: the same tiles with rows of D plus 16 bytes, the
    fp32 P tile (``b_q`` x (``b_kv`` + 4)) and the fp32 output accumulator
    (rows of D rounded up to 32, plus 16)."""
    if dtype_bits == 16:
        dm = attention_head_tile(D)
        row = (dm + 8) * 2
        ring = 2 * cfg["prefetch"] * cfg["b_kv"] * row
        tiles, split = attention_warps(cfg)
        merge = tiles * split * 16 * (dm + 4 + 2) * 4 if split > 1 else 0
        return cfg["b_q"] * row + max(ring, merge)
    row = D * dtype_bits // 8 + 16
    tiles = (cfg["b_q"] + 2 * cfg["prefetch"] * cfg["b_kv"]) * row
    return tiles + cfg["b_q"] * (cfg["b_kv"] + 4) * 4 \
        + cfg["b_q"] * (_round_up(D, 32) + 16) * 4


def attention_regs_per_thread(cfg: Mapping[str, int], dtype_bits: int,
                              D: int) -> int:
    """Estimated registers.  bf16: a warp's mma fragments, per thread the
    16 x tile fp32 accumulator (tile/2), its slice's scores (columns/2),
    the Q fragments where the tile is at most 128 (tile/4), m and l of two
    rows, plus overhead.  fp32: the thread's scores, one 16-byte K vector
    per score column and one Q vector (as floats), four output columns per
    row of P.V, the row's m, l and alpha, plus overhead."""
    if dtype_bits == 16:
        dm = attention_head_tile(D)
        _, split = attention_warps(cfg)
        q_frags = dm // 4 if dm <= 128 else 0
        return dm // 2 + cfg["b_kv"] // split // 2 + q_frags + 4 \
            + ATTN_MMA_REG_OVERHEAD
    tq, tk = cfg["b_q"] // 16, cfg["b_kv"] // 16
    vec = 128 // dtype_bits
    return tq * tk + tk * vec + vec + 4 * tq + 3 * tq + ATTN_REG_OVERHEAD


def attention_fits(cfg: Mapping[str, int], dtype_bits: int, D: int) -> bool:
    """Can the attention kernel launch this config at head dim ``D``?  D
    must be a multiple of 8 (the kernel reads rows in 16-byte pieces), and
    at most the largest head tile in bf16."""
    if not ATTENTION_SPACE.contains(cfg):
        return False
    if dtype_bits not in (16, 32) or D % 8:
        return False
    if dtype_bits == 16 and D > ATTN_HEAD_TILES[-1]:
        return False
    if attention_smem_bytes(cfg, dtype_bits, D) > SMEM_PER_BLOCK:
        return False
    if attention_regs_per_thread(cfg, dtype_bits, D) > MAX_REGS_PER_THREAD:
        return False
    if dtype_bits == 32 and not cfg["acc32"]:
        return False
    return True


def attention_is_legal(cfg: Mapping[str, int], inputs: Mapping[str, int]
                       ) -> bool:
    """Launchable at this head dim, and no tile larger than the problem:
    ``b_q`` at most the packed rows (group*Lq, group = Hq/Hkv) rounded up
    to 16 (a decode step of group 5 takes ``b_q=16``), ``b_kv`` at most
    Lkv rounded up to 16."""
    if not attention_fits(cfg, inputs["dtype_bits"], inputs["D"]):
        return False
    rows = inputs["Hq"] // inputs["Hkv"] * inputs["Lq"]
    return cfg["b_q"] <= _round_up(rows, 16) \
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
SSD_ROW_TILE = 16       # chunk rows whose scores the fp32 body holds at once


def ssd_smem_bytes(cfg: Mapping[str, int], dtype_bits: int, P: int, S: int
                   ) -> int:
    """Dynamic shared memory of one CTA, as ``ssd.cu`` lays it out.

    Both bodies: ``prefetch`` stages of the chunk's x (``b_heads`` x P per
    step), dt, and B and C rows (S plus 16 bytes each); the fp32 state
    (``b_heads`` x P x S); the per-head cumulative decays and state weights.
    fp32 (the CUDA-core body) adds one tile of :data:`SSD_ROW_TILE` score
    rows (fp32, chunk + 4 wide: the chunk x chunk scores are never held
    whole).  bf16 (the ``mma.sync`` body) holds no score tile; it pads the
    x rows to an odd number of 16-byte units and the state rows to S16 + 8
    floats (S16 = S rounded up to 16) where the padded layout fits, so it
    fits wherever the fp32-tile layout would; the padded layout also holds
    a bf16 copy of the state (``b_heads`` x P16 x (S16 + 8), P16 = P
    rounded up to 16) for the read-out's ldmatrix.
    """
    bpe = dtype_bits // 8
    c, bh, stages = cfg["chunk"], cfg["b_heads"], cfg["prefetch"]

    def total(x_row: int, state_row: int, extra: int) -> int:
        stage = c * x_row * bpe + _round_up(c * bh * bpe, 16) \
            + 2 * c * (S * bpe + 16)
        return stages * stage + bh * P * state_row * 4 + extra \
            + 2 * bh * c * 4

    if dtype_bits != 16:
        return total(bh * P, S, SSD_ROW_TILE * (c + 4) * 4)
    x_pad = 8 if (bh * P // 8) % 2 == 0 else 0
    state_copy = bh * _round_up(P, 16) * (_round_up(S, 16) + 8) * 2
    padded = total(bh * P + x_pad, _round_up(S, 16) + 8, state_copy)
    return padded if padded <= SMEM_PER_BLOCK else total(bh * P, S, 0)


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
