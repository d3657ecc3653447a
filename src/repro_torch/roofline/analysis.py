"""Three-term roofline of a dry-run's per-chip op costs (NVIDIA H100 target),
the port of ``repro.roofline.analysis``.

  compute term    = bf16 FLOPs / peak_FLOPs + fp32 FLOPs / peak_FLOPs_fp32  [s]
  memory term     = HBM_bytes_per_chip / HBM_bw          [s]
  collective term = wire_bytes_per_chip / link_bw        [s]

The per-chip costs come from ``repro_torch.roofline.opcount`` (one rank's
dispatched ops), where the reference parses XLA's per-partition HLO.  The
dominant term is the bottleneck; roofline fraction = compute_term /
max(all terms).  ``RooflineReport.mfu`` divides by the report's own
``hw.peak_flops`` (the reference divides by ``V5E``'s whatever ``hw`` it
was given).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.roofline.opcount import OpCosts


@dataclasses.dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float        # per chip, the tensor cores' bf16 dense rate
    hbm_bw: float            # bytes/s per chip
    link_bw: float           # bytes/s per link
    peak_flops_fp32: float   # per chip, fp32 products (the port runs no TF32)


# bf16 dense tensor-core peak and HBM3 bandwidth of an H100 SXM5 80 GB at
# 700 W, NVLink 4's 450 GB/s in each direction, and the fp32 rate outside
# the tensor cores (67 TFLOP/s), where the port's fp32 products run.  A collective that
# leaves an 8-card node runs at the NIC's 50 GB/s (400 Gb/s InfiniBand), so
# on the 256- and 512-chip meshes the collective term is a lower bound.
H100 = HwSpec(name="nvidia-h100-sxm5-80gb-700w", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9,
              peak_flops_fp32=67e12)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float             # 6*N*D (or 6*N_active*D) GLOBAL
    xla_flops_raw: Optional[float] = None   # no XLA: always None, kept for the reference's keys
    xla_bytes_raw: Optional[float] = None
    collective_by_type: Dict[str, float] = dataclasses.field(default_factory=dict)
    temp_bytes: Optional[float] = None      # peak live result bytes per chip
    arg_bytes: Optional[float] = None
    hw: HwSpec = H100

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak: compute term / bottleneck term."""
        t = self.step_time_s
        return self.compute_s / t if t else 0.0

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (counted FLOPs x chips): remat/redundancy waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model FLOPs utilization at the roofline step time, on ``hw``."""
        t = self.step_time_s
        if not t:
            return 0.0
        return self.model_flops / (self.chips * t) / self.hw.peak_flops

    def as_dict(self):
        d = dataclasses.asdict(self)
        d.update(
            dominant=self.dominant,
            step_time_s=self.step_time_s,
            roofline_fraction=self.roofline_fraction,
            useful_flops_fraction=self.useful_flops_fraction,
            mfu=self.mfu,
        )
        return d


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_desc: str,
    chips: int,
    costs: OpCosts,
    model_flops: float,
    arg_bytes: Optional[float] = None,
    hw: HwSpec = H100,
) -> RooflineReport:
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_desc,
        chips=chips,
        flops_per_chip=costs.dot_flops,
        hbm_bytes_per_chip=costs.hbm_bytes,
        wire_bytes_per_chip=costs.collective_wire_bytes,
        compute_s=((costs.dot_flops - costs.dot_flops_fp32) / hw.peak_flops
                   + costs.dot_flops_fp32 / hw.peak_flops_fp32),
        memory_s=costs.hbm_bytes / hw.hbm_bw,
        collective_s=costs.collective_wire_bytes / hw.link_bw,
        model_flops=model_flops,
        collective_by_type=dict(costs.collective_by_type),
        temp_bytes=costs.temp_bytes,
        arg_bytes=arg_bytes,
        hw=hw,
    )


def model_flops_train(cfg, batch: int, seq: int) -> float:
    """6*N*D with N = active params; + attention score/value FLOPs."""
    n_active = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    base = 6.0 * n_active * batch * seq
    return base + batch * _attention_flops(cfg, seq, train=True)


def model_flops_decode(cfg, batch: int, context: int) -> float:
    """Per decode step: 2*N_active*B (fwd only) + attention over the cache."""
    n_active = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    base = 2.0 * n_active * batch
    return base + _attention_flops_decode(cfg, batch, context)


def model_flops_prefill(cfg, batch: int, seq: int) -> float:
    n_active = cfg.active_param_count() if cfg.moe is not None else cfg.param_count()
    return 2.0 * n_active * batch * seq + batch * _attention_flops(cfg, seq, train=False)


def _per_layer_attn_flops(cfg, q_len: int, k_len: int, fwdbwd: float) -> float:
    if cfg.mla is not None:
        dqk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        dv = cfg.mla.v_head_dim
    else:
        dqk = dv = cfg.head_dim_
    return fwdbwd * 2.0 * cfg.num_heads * q_len * k_len * (dqk + dv)


def _attention_flops(cfg, seq: int, train: bool) -> float:
    """Per-sequence causal score+value FLOPs across layers (windows clip k)."""
    fwdbwd = 3.0 if train else 1.0
    total = 0.0
    for pattern, repeat in cfg.groups:
        for blk in pattern:
            if blk.kind != "attn":
                continue
            # average causal k_len; local windows cap it
            avg_k = seq / 2.0 if blk.window <= 0 else min(blk.window, seq / 2.0)
            total += repeat * _per_layer_attn_flops(cfg, seq, avg_k, fwdbwd)
    return total


def _attention_flops_decode(cfg, batch: int, context: int) -> float:
    total = 0.0
    for pattern, repeat in cfg.groups:
        for blk in pattern:
            if blk.kind != "attn":
                continue
            k_len = min(blk.window, context) if blk.window > 0 else context
            total += repeat * batch * _per_layer_attn_flops(cfg, 1, k_len, 1.0)
    return total
