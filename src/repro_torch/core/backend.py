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
pass over it, so it is neither labelled nor picked.

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
from repro_torch.tunedb.session import backend_fingerprint
from repro_torch.tunedb.store import shape_key

L2_BYTES = 50 * 1024 * 1024     # H100 L2: operand copies rotate past it
WARMUP = 1                      # eager calls before a measurement
REPS = 5                        # timed graph replays; the median is kept
MIN_WINDOW_MS = 2.0             # device time one timed graph replay spans
MAX_CALLS = 256                 # launches captured in one graph
CPU_MAX_DIM = 64                # dims of the instance timed on the CPU
OPERAND_SEED = 0                # seeds the timed operands' values


SSD_FLOP_CHUNK = 256            # the chunk the SSD FLOP count is taken at


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
        self.lock = threading.RLock()
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
        dtype = torch.bfloat16 if inputs["dtype_bits"] <= 16 \
            else torch.float32
        x = inputs
        # (shape, dtype, kind) of every operand; all count towards the bytes
        # that must exceed the L2 (K and V, B and C included)
        if space_name == "gemm":
            operands = [((x["M"], x["K"]), dtype, "n"),
                        ((x["K"], x["N"]), dtype, "n")]
        elif space_name == "conv":
            operands = [((x["N"], x["H"], x["W"], x["C"]), dtype, "n"),
                        ((x["R"], x["S"], x["C"], x["K"]), dtype, "n")]
        elif space_name == "attention":
            kv = (x["B"], x["Hkv"], x["Lkv"], x["D"])
            operands = [((x["B"], x["Hq"], x["Lq"], x["D"]), dtype, "n"),
                        (kv, dtype, "n"), (kv, dtype, "n")]
        else:
            bl = (x["B"], x["L"])
            operands = [((*bl, x["H"], x["P"]), dtype, "n"),
                        ((*bl, x["H"]), dtype, "dt"),
                        ((x["H"],), torch.float32, "a"),
                        ((*bl, x["S"]), dtype, "n"),
                        ((*bl, x["S"]), dtype, "n")]
        nbytes = sum(math.prod(s) * t.itemsize for s, t, _ in operands)
        copies = 1 if self.device.type == "cpu" else \
            max(1, min(MAX_CALLS, math.ceil(2 * L2_BYTES / nbytes)))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(OPERAND_SEED)
        stacks = []
        for shape, t, kind in operands:
            if kind == "n":
                v = torch.randn((copies, *shape), generator=gen,
                                device=self.device)
            else:       # SSD: dt in [0.01, 0.1), a in (-2, -0.5]
                v = torch.rand((copies, *shape), generator=gen,
                               device=self.device)
                v = 0.01 + 0.09 * v if kind == "dt" else -(0.5 + 1.5 * v)
            stacks.append(v.to(t))
        sets = [tuple(st[c] for st in stacks) for c in range(copies)]
        self._operands = (key, sets)
        return sets

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


@dataclasses.dataclass
class CheckedBackend:
    """Gate, then time: a config the kernel computes wrongly raises instead
    of labelling a sample (the reference's ``InterpretBackend``).  Each
    (config, gate instance) pair that passes is checked once.  The gate's
    attention and SSD operands and oracles are kept per instance until
    :meth:`release` (a tuning session calls it when it ends)."""

    timer: CudaEventBackend

    def __post_init__(self) -> None:
        self._passed: set = set()
        self._cases = dispatch.GateCases()

    def release(self) -> None:
        """Drop the gate's cached operands and oracles (device memory)."""
        self._cases.clear()

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
