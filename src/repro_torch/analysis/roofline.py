"""Three-term roofline model from dry-run artifacts, for the H100 SXM
(port of ``repro.analysis.roofline``, whose peaks are a TPU v5e's).

    compute term    = FLOPs_per_device / peak FLOP/s (bf16, dense)
    memory term     = bytes_per_device / HBM bandwidth
    collective term = collective_bytes_per_device / link bandwidth

The peaks are ``core/backend.py``'s ``H100_SXM`` (989 TFLOP/s bf16 dense,
3.35 TB/s HBM3); the link is one GPU's NVLink 4 in one direction
(:data:`NVLINK_BW`).  An artifact's quantities are per device.  Unlike
the reference, ``bytes_accessed`` is taken as it stands: the reference
halves it to undo XLA:CPU lowering bf16 programs in f32, and the port's
counts come from the dtypes it runs in.

MODEL_FLOPS accounting (:func:`model_flops`, the reference's, unchanged):
6*N*D for training (fwd 2ND + bwd 4ND), 2*N*D for inference, N = active
parameters, plus the attention S^2 and SSD chunk terms.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.core.backend import H100_SXM

PEAK_FLOPS_BF16 = H100_SXM.bf16_tflops * 1e12   # per GPU
HBM_BW = H100_SXM.hbm_gbps * 1e9                # bytes/s per GPU
# NVIDIA H100 SXM data sheet: NVLink 4 at 900 GB/s per GPU, both
# directions together (18 links); one direction carries half
NVLINK_BW = 450e9                               # bytes/s per GPU

HW = {"peak_flops_bf16": PEAK_FLOPS_BF16, "hbm_bw": HBM_BW,
      "nvlink_bw": NVLINK_BW}


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device raw quantities
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    # the three terms, in seconds
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    # accounting
    model_flops_global: float = 0.0
    useful_ratio: float = 0.0         # MODEL_FLOPS / (FLOPs * chips)
    bottleneck: str = ""
    roofline_fraction: float = 0.0    # useful compute time / max(terms)
    note: str = ""

    def finalize(self) -> "RooflineTerms":
        self.t_compute = self.flops_per_device / PEAK_FLOPS_BF16
        self.t_memory = self.bytes_per_device / HBM_BW
        self.t_collective = self.collective_bytes_per_device / NVLINK_BW
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        bound = max(max(terms.values()), 1e-30)
        useful_t = (self.model_flops_global / self.chips) / PEAK_FLOPS_BF16
        self.roofline_fraction = useful_t / bound
        if self.flops_per_device * self.chips > 0:
            self.useful_ratio = (self.model_flops_global
                                 / (self.flops_per_device * self.chips))
        return self

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def model_flops(cfg, shape, *, kind: str) -> float:
    """Useful-work FLOPs, PaLM-style MFU accounting: parameter FLOPs
    (2*N_active per token forward) PLUS attention score/PV FLOPs (the S^2
    term, causal-halved) and SSD chunk FLOPs — at 32k context the quadratic
    term dominates every transformer, so 6ND alone would make the
    MODEL/HLO ratio meaningless there."""
    n = cfg.active_param_count
    B, S = shape.global_batch, shape.seq_len
    n_attn = sum(1 for mix, _ in cfg.pattern if mix == "attn") \
        * cfg.n_repeats
    n_ssd = cfg.n_layers - n_attn
    H, hd = cfg.n_heads, cfg.hd
    if cfg.is_encdec:
        n_attn += cfg.encoder_layers          # + cross attn below

    if kind in ("train", "prefill"):
        tokens = B * S
        param_f = 2.0 * n * tokens
        # causal self-attention: 2 matmuls x 2BHS^2*hd x 1/2 (causal)
        attn_f = 2.0 * B * H * S * S * hd * n_attn
        if cfg.is_encdec:
            attn_f += 4.0 * B * H * S * cfg.encoder_len * hd * cfg.n_layers
        ssd_f = 0.0
        if n_ssd:
            Q = cfg.ssd_chunk
            di = 2 * cfg.d_model
            Hs = di // cfg.ssm_head_dim
            P, St = cfg.ssm_head_dim, cfg.ssm_state
            # intra-chunk (masked quadratic) + chunk states + inter-chunk
            ssd_f = n_ssd * B * Hs * (S * Q * (P + St)      # intra
                                      + 2 * S * P * St * 2)  # states+inter
        fwd = param_f + attn_f + ssd_f
        return 3.0 * fwd if kind == "train" else fwd
    # decode: one token per sequence against an S-long cache
    param_f = 2.0 * n * B
    attn_f = 4.0 * B * H * S * hd * n_attn
    return param_f + attn_f


def roofline_from_artifacts(artifact: Dict[str, Any],
                            recompute_model_flops: bool = True
                            ) -> RooflineTerms:
    """Terms from one dry-run artifact: ``arch``, ``shape``, ``kind``,
    ``mesh``, ``chips``, ``model_flops``, ``cost.{flops,
    bytes_accessed}`` and ``collectives.total``, all per device.  A
    skipped cell's artifact (``skipped``: the rule's reason) gives zero
    terms, bottleneck ``skipped`` and the reason as its note."""
    if "skipped" in artifact:
        return RooflineTerms(
            arch=artifact["arch"], shape=artifact["shape"],
            mesh=artifact["mesh"], chips=artifact["chips"],
            flops_per_device=0.0, bytes_per_device=0.0,
            collective_bytes_per_device=0.0,
            model_flops_global=artifact["model_flops"],
            bottleneck="skipped", note=f"skipped: {artifact['skipped']}")
    mf = artifact["model_flops"]
    if recompute_model_flops:
        from repro_torch.configs import SHAPES, get_config
        cfg = get_config(artifact["arch"])
        mf = model_flops(cfg, SHAPES[artifact["shape"]],
                         kind=artifact["kind"])
    rt = RooflineTerms(
        arch=artifact["arch"], shape=artifact["shape"], mesh=artifact["mesh"],
        chips=artifact["chips"],
        flops_per_device=artifact["cost"]["flops"],
        bytes_per_device=artifact["cost"]["bytes_accessed"],
        collective_bytes_per_device=artifact["collectives"]["total"],
        model_flops_global=mf,
        note=artifact.get("note", ""),
    )
    return rt.finalize()


def format_table(rows, *, title: str = "") -> str:
    """A markdown table of :class:`RooflineTerms` rows."""
    hdr = ("| arch | shape | mesh | t_compute | t_memory | t_collective | "
           "bottleneck | MODEL/HLO | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [f"### {title}", "", hdr, sep] if title else [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute*1e3:.2f} ms "
            f"| {r.t_memory*1e3:.2f} ms | {r.t_collective*1e3:.2f} ms "
            f"| {r.bottleneck} | {r.useful_ratio:.2f} "
            f"| {r.roofline_fraction:.1%} |")
    return "\n".join(lines)
