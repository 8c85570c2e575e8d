"""Roofline terms of the dry-run: analytic traffic, counted FLOPs.

The port of `repro.launch.roofline`, analytic half:

  compute    = FLOPs_dev / peak_bf16
  memory     = bytes_dev / hbm_bw          (the analytic traffic model)
  collective = coll_bytes_dev / (ici_bw_per_link * ici_links / 2)

The reference reads FLOPs, bytes and collective bytes from an XLA
executable (``cost_analysis``, the HLO text). The port has none: the
dry-run (`launch.dryrun`) counts the FLOPs of the cell's step on meta
tensors (``torch.utils.flop_counter``) and the bytes every operator reads
and writes, and `analyze_counts` prices them against the device spec
(``h100-sxm`` by default, data-sheet peaks, NVLink for the collective
term: `core.models.roofline`). A stencil (girih) cell's collective bytes
are what the multi-process stepper's carrier sends from an interior shard
in one super-step (`distributed.stepper.interior_halo_bytes`, the
reference's ``collective-permute``). An LM cell's are what one device
of the sharded LM step issues in the cell's step, by kind
(`launch.dryrun.count_collectives`: `training.spmd`'s calls on meta
blocks, counted and not run), in the reference's convention (an
operand's bytes).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import specs as devspecs
from repro_torch.core.models import RooflineTerms, roofline
from repro_torch.optim.optimizers import tree_paths

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def analytic_hbm_bytes(cfg, shape_info: dict, n_params: int, n_active: int,
                       n_devices: int, *, accum: int = 1, tp: int = 16) -> float:
    """Per-device HBM traffic model (drives the memory roofline term).

    train:  params bf16 read (fwd+bwd+remat = 3 x 2N) + f32 grad write+read
            per accumulation round (accum x 2 x 4N) + AdamW m,v read/write
            (4 x 4N, upper bound for Adafactor) + activations ~24 x d_model
            bf16 streams per token-layer, TP-sharded.
    prefill: params read once + 8 streams/token-layer + KV write.
    decode:  active params read once + KV/state cache read + append.
    """
    kind = shape_info["kind"]
    toks = shape_info["global_batch"] * shape_info["seq_len"]
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    kv_bytes_tok = 2 * cfg.n_kv_heads * hd * 2  # k+v bf16 per attn layer
    n_attn = sum(cfg.layer_kind(i) != "mamba" for i in range(L))
    if kind == "train":
        params = (3 * 2 + accum * 2 * 4 + 4 * 4) * float(n_params)
        act = 24.0 * 2 * d * L * toks / tp
        return (params + act) / n_devices
    if kind == "prefill":
        params = 2.0 * n_params
        act = 8.0 * 2 * d * L * toks / tp
        kv_write = float(toks) * kv_bytes_tok * n_attn
        return (params + act + kv_write) / n_devices
    b = shape_info["global_batch"]
    cache_read = 0.0
    for i in range(L):
        k = cfg.layer_kind(i)
        if k == "global":
            cache_read += b * shape_info["seq_len"] * kv_bytes_tok
        elif k == "local":
            cache_read += b * min(cfg.window,
                                  shape_info["seq_len"]) * kv_bytes_tok
        else:  # mamba state r/w
            cache_read += 2 * b * cfg.ssm_heads * cfg.ssm_state \
                * cfg.ssm_head_dim * 4
    return (2.0 * n_active + cache_read) / n_devices


@dataclasses.dataclass
class DryrunResult:
    """One dry-run cell's roofline record (JSON-serializable).

    `bytes_per_device` is every operator's operand and result bytes as
    eager PyTorch runs them, unfused (the reference's HLO ``bytes
    accessed``), None where the step could not run on meta tensors;
    `peak_bytes_per_device` is None: nothing measures temporaries without
    a compiler's memory analysis. `lower_s` is the counting time."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float | None   # counted operator bytes (diagnostic)
    model_bytes_per_device: float    # analytic HBM model (memory term)
    coll_bytes: dict[str, float]
    peak_bytes_per_device: float | None
    arg_bytes_per_device: float
    model_flops_global: float
    terms: RooflineTerms             # memory term from the analytic model
    terms_hlo: RooflineTerms | None  # memory term from the counted bytes
    lower_s: float
    compile_s: float
    notes: str = ""

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (remat/dispatch/redundancy waste)."""
        counted = self.flops_per_device * self.n_devices
        return self.model_flops_global / counted if counted else 0.0

    def to_json(self) -> dict:
        """Flat JSON form consumed by `launch.report`'s tables (the
        reference's keys)."""
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_devices": self.n_devices,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "model_bytes_per_device": self.model_bytes_per_device,
            "coll_bytes": self.coll_bytes,
            "peak_bytes_per_device": self.peak_bytes_per_device,
            "arg_bytes_per_device": self.arg_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "t_compute": self.terms.t_compute,
            "t_memory": self.terms.t_memory,
            "t_memory_hlo": (self.terms_hlo.t_memory if self.terms_hlo
                             else None),
            "t_collective": self.terms.t_collective,
            "t_latency": self.terms.t_latency,
            "dominant": self.terms.dominant,
            "roofline_fraction": self.terms.roofline_fraction,
            "lower_s": self.lower_s, "compile_s": self.compile_s,
            "notes": self.notes,
        }


def analyze_counts(*, arch: str, shape: str, mesh_name: str, n_devices: int,
                   flops_per_device: float, bytes_per_device: float | None,
                   arg_bytes_per_device: float, model_flops: float,
                   model_bytes: float, lower_s: float, notes: str = "",
                   coll_bytes: dict[str, float] | None = None,
                   chip: devspecs.DeviceSpec | None = None) -> DryrunResult:
    """The roofline record of one cell from its counted FLOPs and bytes,
    its per-device collective bytes by kind (`COLLECTIVES`, default none)
    and its per-device argument bytes (the reference's `analyze` reads
    them from a compiled executable). `chip=None` prices the terms against
    the process default device spec (``--spec`` /
    ``$REPRO_TORCH_DEVICE_SPEC``, else ``h100-sxm``)."""
    chip = chip or devspecs.current_spec()
    coll = {k: 0.0 for k in COLLECTIVES}
    coll.update(coll_bytes or {})
    total = sum(coll.values())
    return DryrunResult(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=flops_per_device, bytes_per_device=bytes_per_device,
        model_bytes_per_device=model_bytes,
        coll_bytes=coll,
        peak_bytes_per_device=None,
        arg_bytes_per_device=float(arg_bytes_per_device),
        model_flops_global=model_flops,
        terms=roofline(flops_per_device, model_bytes, total, chip),
        terms_hlo=(roofline(flops_per_device, bytes_per_device, total, chip)
                   if bytes_per_device is not None else None),
        lower_s=lower_s, compile_s=0.0, notes=notes)


def model_flops(cfg, shape_info: dict, n_params: int,
                n_active_params: int) -> float:
    """6*N*D (train) / 2*N*D (prefill) / 2*N*B (decode), N = active params."""
    kind = shape_info["kind"]
    if kind == "train":
        tokens = shape_info["global_batch"] * shape_info["seq_len"]
        return 6.0 * n_active_params * tokens
    if kind == "prefill":
        tokens = shape_info["global_batch"] * shape_info["seq_len"]
        return 2.0 * n_active_params * tokens
    return 2.0 * n_active_params * shape_info["global_batch"]


def active_params(cfg, spec_tree) -> tuple[int, int]:
    """(total, active) parameter counts (MoE: top-k fraction of experts)."""
    total = active = 0
    for name, s in tree_paths(spec_tree):
        n = int(np.prod(s.shape))
        total += n
        is_expert = (cfg.n_experts and "'ffn'" in name
                     and ("wi_gate" in name or "wi_up" in name
                          or "'wo'" in name)
                     and cfg.n_experts in s.shape[:2])  # unrolled or stacked
        if is_expert:
            active += n * cfg.experts_per_token // cfg.n_experts
        else:
            active += n
    return total, active
