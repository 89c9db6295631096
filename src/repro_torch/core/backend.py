"""Measurement backends of the port: the oracle that labels
(config, inputs) -> TFLOPS.

  * :class:`CudaEventBackend` times the port's own kernel — ``ops.matmul``,
    ``ops.conv2d``, ``ops.flash_attention`` or ``ops.ssd_scan`` under the
    config, which launches ``csrc/{gemm,conv,attention,ssd}.cu`` — with
    CUDA events on the card.  It never times ``torch.matmul``,
    ``F.conv2d`` or SDPA: a record that says what a config does must come
    from the kernel that runs the config (the reference's
    ``WallClockBackend`` times ``jnp.matmul``, not its Pallas kernel).
    Attention runs causal only where the gate does (Lq == Lkv).
  * :class:`CheckedBackend` mirrors the reference's ``InterpretBackend``:
    the correctness gate (``dispatch.check_config``) first, then the
    timing backend it wraps.

Both expose ``measure(space_name, cfg, inputs) -> TFLOPS`` and
``time_us(space_name, cfg, inputs) -> µs``, as the reference's backends do.
The reference's ``SimulatedTPUBackend`` is a TPU v5e speed model and is
not ported: nothing it says holds for the card.

Measurements are serialised by a lock in the backend: a tuning session
runs its jobs on several threads, and kernels timed at the same time on
one card would corrupt each other's event windows.

A config the gate rejects raises :class:`~repro_torch.core.space.
ConfigRejected`; the dataset generator and the search's re-measurement
pass over it, so it is neither labelled nor picked.  A training draw whose
call, memory or (SSD) gate oracle would not fit the card's per-draw
budgets (:meth:`CudaEventBackend.fits`) is dropped from the dataset's pool
before any config is drawn for it.

A GEMM timed with ``trans_a`` / ``trans_b`` set gets its operand stored
transposed and passed as a transposed view, so the time includes the
relayout ``ops.matmul`` makes before the row-major kernel: what the flag
costs on this card (the reference's simulated backend charges a
relayout too).

On ``device="cpu"`` (asked for by name, never a fallback) the backend times
the kernels' plain versions with ``perf_counter`` on a shrunken instance
(every dim capped at :data:`CPU_MAX_DIM`), so the tuning loop runs in the
CPU tests.  Those numbers describe the host, and the fingerprint says so.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import dispatch, ops
from repro_torch.kernels.matmul import PLAIN_BLOCK_BYTES
from repro_torch.tunedb.session import backend_fingerprint
from repro_torch.tunedb.store import shape_key

L2_BYTES = 50 * 1024 * 1024     # H100 L2: operand copies rotate past it

# H100 SXM data-sheet peaks (dense), the port's target card: what bound
# times and store-aware admission's roofline divide by (the reference's
# ``core.backend`` holds a TPU v5e's under the same names)
PEAK_BF16_TFLOPS = 989.0
PEAK_FP32_TFLOPS = 67.0
HBM_GBPS = 3350.0


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A chip's dense peak rates: TFLOP/s per IO dtype and HBM GB/s."""

    bf16_tflops: float
    fp32_tflops: float
    hbm_gbps: float


H100_SXM = Peaks(PEAK_BF16_TFLOPS, PEAK_FP32_TFLOPS, HBM_GBPS)
WARMUP = 1                      # eager calls before a measurement
REPS = 5                        # timed graph replays; the median is kept
MIN_WINDOW_MS = 2.0             # device time one timed graph replay spans
MAX_CALLS = 256                 # launches captured in one graph
CPU_MAX_DIM = 64                # dims of the instance timed on the CPU
OPERAND_SEED = 0                # seeds the timed operands' values


SSD_FLOP_CHUNK = 256            # the chunk the SSD FLOP count is taken at

# What one training draw may cost on the card, gate included (about a
# second at most): the FLOPs of one call, the share of the card's free
# memory the draw's tensors may hold at once, and for SSD the steps of the
# gate's fp32 oracle.  That oracle (``ref.ssd_ref``) is a Python loop with
# one step a time step, which no FLOP count bounds: about 0.25 ms a step
# on the card's host, plus about as much again per 2**23 state elements
# B·H·P·S (``tools/tune_draw_cost.py``, NVIDIA H100 80GB HBM3), so
# :func:`ssd_oracle_steps` counts a step of a larger state as more.
FLOP_BUDGET = 2.5e11
MEM_SHARE = 0.5
SSD_STEP_BUDGET = 4096
SSD_STATE_PER_STEP = 1 << 23

# held by every timing measurement and gate check on the card, and by the
# serving engine around each CUDA-graph capture (``Engine._captured``): a
# capture in the default global mode must not overlap another thread's
# measurement, whose synchronisations, allocations and own thread-local
# capture would invalidate it.  One lock for the process: one measurement
# runs on a card at a time.
DEVICE_LOCK = threading.RLock()


def problem_flops(space_name: str, inputs: Mapping[str, int]) -> float:
    """FLOPs of one call, from the shape alone (a yardstick that moves with
    the config would rank configs by it): 2MNK for GEMM, 2·N·P·Q·K·C·R·S
    for conv, 4·B·Hq·Lq·Lkv·D for attention (halved when causal with
    Lq == Lkv), and for SSD the chunked form at a fixed chunk c =
    min(256, L): 2·B·H·nc·(c²(P+S) + 2cSP + PS) over nc = ceil(L/c)
    chunks."""
    x = inputs
    if space_name == "gemm":
        return 2.0 * x["M"] * x["N"] * x["K"]
    if space_name == "conv":
        return 2.0 * x["N"] * x["H"] * x["W"] * x["K"] * x["C"] * x["R"] \
            * x["S"]
    if space_name == "attention":
        frac = 0.5 if x.get("causal", 0) and x["Lq"] == x["Lkv"] else 1.0
        return 4.0 * x["B"] * x["Hq"] * x["Lq"] * x["Lkv"] * x["D"] * frac
    if space_name == "ssd":
        c = min(SSD_FLOP_CHUNK, x["L"])
        nc = -(-x["L"] // c)
        P, S = x["P"], x["S"]
        return 2.0 * x["B"] * x["H"] * nc * (c * c * (P + S) + 2 * c * S * P
                                             + P * S)
    raise ValueError(f"no ported kernel for space {space_name!r}")


def _io_dtype(inputs: Mapping[str, int]) -> torch.dtype:
    return torch.bfloat16 if inputs["dtype_bits"] <= 16 else torch.float32


def operand_specs(space_name: str, inputs: Mapping[str, int]
                  ) -> List[Tuple[Tuple[int, ...], torch.dtype, str]]:
    """(shape, dtype, kind) of every operand the timer passes to one call;
    all count towards the bytes that must exceed the L2 (K and V, B and C
    included).  A GEMM operand whose flag says transposed is stored so (A
    as (K, M), B as (N, K)) and passed as its .t() view ("nt")."""
    x, dtype = inputs, _io_dtype(inputs)
    if space_name == "gemm":
        return [((x["K"], x["M"]), dtype, "nt") if x.get("trans_a")
                else ((x["M"], x["K"]), dtype, "n"),
                ((x["N"], x["K"]), dtype, "nt") if x.get("trans_b")
                else ((x["K"], x["N"]), dtype, "n")]
    if space_name == "conv":
        return [((x["N"], x["H"], x["W"], x["C"]), dtype, "n"),
                ((x["R"], x["S"], x["C"], x["K"]), dtype, "n")]
    if space_name == "attention":
        kv = (x["B"], x["Hkv"], x["Lkv"], x["D"])
        return [((x["B"], x["Hq"], x["Lq"], x["D"]), dtype, "n"),
                (kv, dtype, "n"), (kv, dtype, "n")]
    if space_name == "ssd":
        bl = (x["B"], x["L"])
        return [((*bl, x["H"], x["P"]), dtype, "n"),
                ((*bl, x["H"]), dtype, "dt"),
                ((x["H"],), torch.float32, "a"),
                ((*bl, x["S"]), dtype, "n"),
                ((*bl, x["S"]), dtype, "n")]
    raise ValueError(f"no ported kernel for space {space_name!r}")


def operand_copies(space_name: str, inputs: Mapping[str, int]) -> int:
    """Operand sets the card's timer cycles through: enough that their
    bytes exceed twice the L2, at most :data:`MAX_CALLS`."""
    nbytes = sum(math.prod(s) * t.itemsize
                 for s, t, _ in operand_specs(space_name, inputs))
    return max(1, min(MAX_CALLS, math.ceil(2 * L2_BYTES / nbytes)))


def footprint_bytes(space_name: str, inputs: Mapping[str, int]) -> int:
    """Device bytes one labelled draw may hold at once on the card, summed
    over its parts, each counted at its own peak: the timer's operand sets
    and two calls' outputs and split partials; the gate's operands (drawn
    in fp32), its fp32 oracle, its kernel run and its plain version, all at
    the whole shape, under the config of the draw's shape that needs the
    most (up to 8 GEMM or 16 conv split partials; K or C padded to the
    split chunk, under 2K + 256 or 2C + 64).  Each part's peak was
    measured per draw by ``tools/tune_draw_cost.py`` and this sum bounds
    it."""
    x = inputs
    e = _io_dtype(x).itemsize
    timer = operand_copies(space_name, x) * sum(
        math.prod(s) * t.itemsize for s, t, _ in operand_specs(space_name, x))
    if space_name == "gemm":
        M, N, K = x["M"], x["N"], x["K"]
        kp, mn = 2 * K + 256, M * N
        ab, abp = M * K + K * N, M * kp + kp * N
        parts = (8 * mn * (e + 4) + mn * (8 + e))     # one call's partials
        # timer calls (the relayout of a transposed operand); the gate's
        # draws, IO copies and oracle; the plain version's padded fp32
        # copies and its block of rounded acc32=0 sub-dots
        # (matmul.PLAIN_BLOCK_BYTES in fp32 and in the IO dtype)
        total = (timer + 2 * (ab * e + parts) + ab * (8 + e) + 8 * mn
                 + parts + 12 * abp
                 + min(3 * PLAIN_BLOCK_BYTES // 2, (kp // 8) * mn * (4 + e))
                 + 16 * mn * (4 + e))
    elif space_name == "conv":
        N, H, W, C, K, R, S = (x[k] for k in "NHWCKRS")
        npq, cp, rs = N * H * W, 2 * C + 64, R * S
        io = N * H * W * C + rs * C * K
        parts = 16 * npq * K * (e + 4) + npq * K * (8 + e)
        padded = N * (H + R) * (W + S) * cp
        # timer calls; the gate's draws, IO copies and its oracle (an
        # im2col of one image, fp32 copies of the operands, the output);
        # the plain version: the padded input, every (r, s) window of it
        # (a list, its stack and a split's slice), the padded filter, the
        # windows' products
        total = (timer + 2 * parts + io * (8 + e)
                 + 4 * (padded + C * rs * H * W + 2 * npq * K) + parts
                 + 4 * (2 * padded + 3 * rs * npq * cp + 2 * rs * cp * K
                        + 2 * rs * npq * K) + rs * npq * K * e)
    elif space_name == "attention":
        B, Hq, Lq, D = x["B"], x["Hq"], x["Lq"], x["D"]
        group = Hq // x["Hkv"]
        q, kv = B * Hq * Lq * D, B * x["Hkv"] * x["Lkv"] * D
        scores = min(dispatch.ORACLE_SCORE_BYTES // 4,
                     B * group * Lq * x["Lkv"])
        # q and the output (draw, plain accumulator, oracle); K and V; the
        # oracle's repeated K/V of one head and its score blocks; the plain
        # version's score block (b_kv <= 128) and repeated K/V block
        total = timer + 4 * (8 * q + 4 * kv + 2 * B * group * x["Lkv"] * D
                             + 4 * scores + 6 * B * Hq * Lq * 128
                             + 2 * B * Hq * 128 * D)
    elif space_name == "ssd":
        B, L, H, P, S = (x[k] for k in ("B", "L", "H", "P", "S"))
        # x and y (draws, padded copies, the per-step and per-chunk outputs
        # and their stacks); dt, B and C; the plain version's chunk x chunk
        # decay blocks (chunk <= 256); the state
        total = timer + 4 * (8 * B * L * H * P + 4 * B * L * (H + 2 * S)
                             + 4 * B * 256 * 256 * H + 2 * B * H * P * S)
    else:
        raise ValueError(f"no ported kernel for space {space_name!r}")
    return int(total)


def ssd_oracle_steps(inputs: Mapping[str, int]) -> float:
    """The SSD gate oracle's time steps, each weighted by its state size:
    L · (1 + B·H·P·S / :data:`SSD_STATE_PER_STEP`)."""
    x = inputs
    return x["L"] * (1 + x["B"] * x["H"] * x["P"] * x["S"]
                     / SSD_STATE_PER_STEP)


def draw_fits(space_name: str, inputs: Mapping[str, int],
              free_bytes: int) -> bool:
    """Can a training draw at ``inputs`` be labelled on a card with
    ``free_bytes`` free: one call within :data:`FLOP_BUDGET`, its
    :func:`footprint_bytes` within :data:`MEM_SHARE` of the free memory,
    and for SSD the oracle's :func:`ssd_oracle_steps` within
    :data:`SSD_STEP_BUDGET`."""
    return (problem_flops(space_name, inputs) <= FLOP_BUDGET
            and footprint_bytes(space_name, inputs) <= MEM_SHARE * free_bytes
            and (space_name != "ssd"
                 or ssd_oracle_steps(inputs) <= SSD_STEP_BUDGET))


def _cfg_key(cfg: Mapping[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted((k, int(v)) for k, v in cfg.items()))


@dataclasses.dataclass
class CudaEventBackend:
    """Times the port's kernels under a config (CUDA events, graph replay).

    One measurement: :data:`WARMUP` eager calls, one more between events to
    size the window, then ``n`` calls captured in a CUDA graph (no host
    gaps between launches, which would inflate a ~17 µs kernel) and
    replayed :data:`REPS` times; the median replay over ``n`` is the time.
    The calls cycle through enough operand copies that their bytes exceed
    twice the L2, so each call reads its operands cold, as a serving
    process's GEMMs read their weights.  The device is the only field, so
    the fingerprint names the package, the class and the device.
    """

    device: DeviceLike = None

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.lock = DEVICE_LOCK
        self._times: Dict[tuple, float] = {}
        self._operands: Tuple[tuple, List[Tuple[torch.Tensor, ...]]] = (
            (), [])

    @property
    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    @property
    def fingerprint(self) -> str:
        return backend_fingerprint(self)

    # -- operands ------------------------------------------------------------
    def instance(self, space_name: str, inputs: Mapping[str, int]
                 ) -> Dict[str, int]:
        """The problem actually timed: the shape itself on the card, a
        shrunken one on the CPU."""
        if self.device.type == "cpu":
            return dispatch.check_instance(space_name, inputs,
                                           max_dim=CPU_MAX_DIM)
        return dict(inputs)

    def _operand_sets(self, space_name: str, inputs: Mapping[str, int]
                      ) -> List[Tuple[torch.Tensor, ...]]:
        key = (space_name, shape_key(inputs))
        if self._operands[0] == key:
            return self._operands[1]
        self._operands = ((), [])               # free the last shape first
        operands = operand_specs(space_name, inputs)
        copies = 1 if self.device.type == "cpu" else \
            operand_copies(space_name, inputs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(OPERAND_SEED)
        stacks = []
        for shape, t, kind in operands:    # drawn in their own dtype
            if kind in ("n", "nt"):
                v = torch.randn((copies, *shape), generator=gen,
                                device=self.device, dtype=t)
            else:       # SSD: dt in [0.01, 0.1), a in (-2, -0.5]
                v = torch.rand((copies, *shape), generator=gen,
                               device=self.device, dtype=t)
                v = 0.01 + 0.09 * v if kind == "dt" else -(0.5 + 1.5 * v)
            stacks.append(v)
        del v
        sets = [tuple(st[c].t() if kind == "nt" else st[c]
                      for st, (_, _, kind) in zip(stacks, operands))
                for c in range(copies)]
        self._operands = (key, sets)
        return sets

    def fits(self, space_name: str, inputs: Mapping[str, int]) -> bool:
        """Can a training draw at ``inputs`` be labelled here within the
        per-call budgets (:func:`draw_fits`, against the card's free memory
        now)?  The CPU backend labels a shrunken instance and refuses
        nothing."""
        if self.device.type == "cpu":
            return True
        free, _ = torch.cuda.mem_get_info(self.device)
        return draw_fits(space_name, inputs, free)

    # -- timing --------------------------------------------------------------
    def _time_cpu_ms(self, fn: Callable[[int], Any]) -> float:
        for _ in range(WARMUP):
            fn(0)
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn(0)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def _time_cuda_ms(self, fn: Callable[[int], Any], n_sets: int) -> float:
        dev = self.device
        for i in range(WARMUP):
            fn(i % n_sets)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(0)
        e1.record()
        e1.synchronize()
        one = max(e0.elapsed_time(e1), 1e-3)
        n = max(n_sets, min(MAX_CALLS, math.ceil(MIN_WINDOW_MS / one)))
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(0)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for i in range(n):
                fn(i % n_sets)
        graph.replay()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(REPS):
            e0.record()
            graph.replay()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1) / n)
        del graph
        return statistics.median(times)

    def time_ms(self, space_name: str, cfg: Mapping[str, int],
                inputs: Mapping[str, int]) -> float:
        """Median time of one ``ops`` call under ``cfg`` (a fresh
        measurement; :meth:`time_us` reuses the last one)."""
        with self.lock:
            inst = self.instance(space_name, inputs)
            sets = self._operand_sets(space_name, inst)
            if space_name == "gemm":
                fn = lambda i: ops.matmul(*sets[i], cfg)
            elif space_name == "conv":
                fn = lambda i: ops.conv2d(*sets[i], cfg)
            elif space_name == "attention":
                causal = dispatch.gate_causal(inst)
                fn = lambda i: ops.flash_attention(*sets[i], cfg,
                                                   causal=causal)
            elif space_name == "ssd":
                fn = lambda i: ops.ssd_scan(*sets[i], cfg)
            else:
                raise ValueError(f"no ported kernel for space {space_name!r}")
            if self.device.type == "cpu":
                ms = self._time_cpu_ms(fn)
            else:
                with torch.cuda.device(self.device):
                    ms = self._time_cuda_ms(fn, len(sets))
            self._times[(space_name, shape_key(inputs), _cfg_key(cfg))] = \
                ms * 1e3
            return ms

    def measure(self, space_name: str, cfg: Mapping[str, int],
                inputs: Mapping[str, int]) -> float:
        """TFLOPS of the kernel under ``cfg`` at ``inputs``."""
        ms = self.time_ms(space_name, cfg, inputs)
        flops = problem_flops(space_name, self.instance(space_name, inputs))
        return flops / (ms * 1e-3) / 1e12

    def time_us(self, space_name: str, cfg: Mapping[str, int],
                inputs: Mapping[str, int]) -> float:
        """µs of the last measurement of (cfg, inputs), measuring if none."""
        got = self._times.get((space_name, shape_key(inputs), _cfg_key(cfg)))
        if got is None:
            got = self.time_ms(space_name, cfg, inputs) * 1e3
        return got

    def release(self) -> None:
        """Drop the last shape's operand sets (device memory, at least
        twice the L2) and the timing log.  A later measurement draws its
        operands again from :data:`OPERAND_SEED`, so it times the same
        numbers."""
        with self.lock:
            self._operands = ((), [])
            self._times.clear()


@dataclasses.dataclass
class CheckedBackend:
    """Gate, then time: a config the kernel computes wrongly raises instead
    of labelling a sample (the reference's ``InterpretBackend``).  Each
    (config, gate instance) pair that passes is checked once.  The gate's
    attention and SSD operands and oracles are kept per instance until
    :meth:`release` (a tuning session calls it when it ends), which drops
    the timer's operand sets and timing log too."""

    timer: CudaEventBackend

    def __post_init__(self) -> None:
        self._passed: set = set()
        self._cases = dispatch.GateCases()

    def release(self) -> None:
        """Drop the gate's cached operands and oracles and the timer's
        operand sets and timing log (device memory)."""
        self._cases.clear()
        self.timer.release()

    @property
    def fingerprint(self) -> str:
        return backend_fingerprint(self)

    def check(self, space_name: str, cfg: Mapping[str, int],
              inputs: Mapping[str, int]) -> None:
        """Gate ``cfg`` at the instance the timer runs: the whole shape on
        the card; on the CPU the shrunken one, shrunk further as
        ``check_config`` does there."""
        inst = self.timer.instance(space_name, inputs)
        key = (space_name, shape_key(dispatch.gate_instance(
            space_name, inst, self.timer.device)), _cfg_key(cfg))
        if key in self._passed:
            return
        with self.timer.lock:
            dispatch.check_config(space_name, cfg, inst,
                                  device=self.timer.device,
                                  cases=self._cases)
        self._passed.add(key)

    def fits(self, space_name: str, inputs: Mapping[str, int]) -> bool:
        return self.timer.fits(space_name, inputs)

    def measure(self, space_name: str, cfg: Mapping[str, int],
                inputs: Mapping[str, int]) -> float:
        self.check(space_name, cfg, inputs)
        return self.timer.measure(space_name, cfg, inputs)

    def time_us(self, space_name: str, cfg: Mapping[str, int],
                inputs: Mapping[str, int]) -> float:
        """Gated as :meth:`measure` is: a search that did not re-measure
        its winner still never records a config the gate rejects."""
        self.check(space_name, cfg, inputs)
        return self.timer.time_us(space_name, cfg, inputs)
