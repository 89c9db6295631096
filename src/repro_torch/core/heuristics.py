"""Vendor-library baseline for the port: fixed menus of Hopper-legal tiles
and size-bucketed selection heuristics (the "cuBLAS"/"cuDNN" bars of the
paper).

The menus mirror ``repro.core.heuristics`` in spirit — a few square-ish
tiles, no in-block reduction unrolling, one global-split variant for GEMM
and none for conv — rebuilt from tiles the hand-written kernels can launch
(the reference's menus have ``bn=1024``, ``bk=1024`` and conv ``b_k=256``,
which no CTA of these kernels holds).

Two query modes mirror the paper's protocol: ``select`` (the heuristic
choice) and ``best_kernel`` (exhaustive over the static menu).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Mapping, Tuple

from .space import Config, ParamSpace

VENDOR_GEMM_MENU: Tuple[Config, ...] = tuple(
    {"bm": bm, "bn": bn, "bk": bk, "k_unroll": 1, "k_split": ks,
     "order": 0, "acc32": 1, "prefetch": 2}
    for bm, bn in ((16, 64), (32, 64), (64, 128), (128, 128))
    for bk in (64, 128)
    for ks in (1, 4)
)

VENDOR_CONV_MENU: Tuple[Config, ...] = tuple(
    {"b_npq": bnpq, "b_k": bk, "b_c": bc, "rs_unroll": 1, "c_split": 1,
     "order": 0, "acc32": 1, "prefetch": 2}
    for bnpq in (32, 64, 128)
    for bk in (32, 64)
    for bc in (8, 16, 32)
)


@dataclasses.dataclass
class VendorHeuristicLibrary:
    """Fixed-menu library with size-bucketed selection heuristics."""

    space: ParamSpace
    menu: Tuple[Config, ...]

    @classmethod
    def gemm(cls, space: ParamSpace) -> "VendorHeuristicLibrary":
        return cls(space=space, menu=VENDOR_GEMM_MENU)

    @classmethod
    def conv(cls, space: ParamSpace) -> "VendorHeuristicLibrary":
        return cls(space=space, menu=VENDOR_CONV_MENU)

    def legal_menu(self, inputs: Mapping[str, int]) -> List[Config]:
        out = [c for c in self.menu if self.space.is_legal(c, inputs)]
        if not out:
            # vendor fallback kernel: smallest tiles in the menu
            out = [dict(min(self.menu, key=lambda c: sum(c.values())))]
        return out

    def select(self, inputs: Mapping[str, int]) -> Config:
        legal = self.legal_menu(inputs)
        if self.space.name == "conv":
            want = self._conv_want(inputs)
        else:
            want = self._gemm_want(inputs)

        def dist(c: Config) -> float:
            return sum(abs(c.get(k, 0) - v) / max(v, 1) for k, v in want.items())
        return dict(min(legal, key=dist))

    @staticmethod
    def _gemm_want(inputs: Mapping[str, int]) -> Config:
        M, N, K = inputs["M"], inputs["N"], inputs["K"]
        if M >= 2048 and N >= 2048:
            want = {"bm": 128, "bn": 128, "bk": 64, "k_split": 1}
        elif M >= 512 and N >= 512:
            want = {"bm": 64, "bn": 128, "bk": 128, "k_split": 1}
        elif K >= 8192 and M * N <= 256 * 256:
            want = {"bm": 32, "bn": 64, "bk": 128, "k_split": 4}
        elif M <= 64:
            # skinny: too few output tiles to fill the card, split K
            want = {"bm": 16, "bn": 64, "bk": 64, "k_split": 4}
        else:
            want = {"bm": 64, "bn": 128, "bk": 128, "k_split": 1}
        return want

    @staticmethod
    def _conv_want(inputs: Mapping[str, int]) -> Config:
        # bucket by output pixels, as the reference does; channel slab by C
        npq = inputs["N"] * inputs["H"] * inputs["W"]
        if npq >= 65536:
            want = {"b_npq": 128, "b_k": 64}
        elif npq >= 8192:
            want = {"b_npq": 64, "b_k": 64}
        else:
            want = {"b_npq": 32, "b_k": 32}
        want["b_c"] = 32 if inputs["C"] >= 32 else 8
        return want

    def best_kernel(self, inputs: Mapping[str, int],
                    measure: Callable[[Config], float]) -> Tuple[Config, float]:
        """Exhaustive over the static menu (the paper's "Best Kernel")."""
        scored = [(c, measure(c)) for c in self.legal_menu(inputs)]
        return max(scored, key=lambda t: t[1])
