"""Vendor-library baseline for the port: a fixed menu of Hopper-legal tiles
and a size-bucketed selection heuristic (the "cuBLAS" bar of the paper).

The menu mirrors ``repro.core.heuristics`` in spirit — a few square-ish
tiles, ``k_unroll=1``, one global-split variant — rebuilt from tiles the
hand-written kernel can launch (the reference's menu has ``bn=1024`` and
``bk=1024``, which no CTA holds).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Tuple

from .space import Config, ParamSpace

VENDOR_GEMM_MENU: Tuple[Config, ...] = tuple(
    {"bm": bm, "bn": bn, "bk": bk, "k_unroll": 1, "k_split": ks,
     "order": 0, "acc32": 1, "prefetch": 2}
    for bm, bn in ((16, 64), (32, 64), (64, 128), (128, 128))
    for bk in (64, 128)
    for ks in (1, 4)
)


@dataclasses.dataclass
class VendorHeuristicLibrary:
    """Fixed-menu library with size-bucketed selection heuristics."""

    space: ParamSpace
    menu: Tuple[Config, ...]

    @classmethod
    def gemm(cls, space: ParamSpace) -> "VendorHeuristicLibrary":
        return cls(space=space, menu=VENDOR_GEMM_MENU)

    def legal_menu(self, inputs: Mapping[str, int]) -> List[Config]:
        out = [c for c in self.menu if self.space.is_legal(c, inputs)]
        if not out:
            # vendor fallback kernel: smallest tiles in the menu
            out = [dict(min(self.menu, key=lambda c: sum(c.values())))]
        return out

    def select(self, inputs: Mapping[str, int]) -> Config:
        legal = self.legal_menu(inputs)
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

        def dist(c: Config) -> float:
            return sum(abs(c.get(k, 0) - v) / max(v, 1) for k, v in want.items())
        return dict(min(legal, key=dist))
