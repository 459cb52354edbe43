"""Roofline of a dry-run cell on the NVIDIA H100 SXM (no hardware
required).

Three terms per (arch x shape x mesh), in seconds:
  compute    = FLOPs / (chips * peak_flops)
  memory     = HBM bytes / (chips * HBM_BW)
  collective = collective bytes / (chips * ICI_BW)

The counts come from the cell's specs (:func:`from_cell`): eager PyTorch
has no compiled module, so there is no ``cost_analysis`` to read and no
HLO to parse. The FLOPs are the cell's analytic ``model_flops``, the
bytes the least traffic the step must make (a table that a serving step
gathers counts at its ids' rows only), and the collective bytes 0,
since one process drives every shard of a port mesh.
:func:`parse_collective_bytes` stays for HLO text from elsewhere.

Hardware constants (H100 SXM5, NVIDIA's H100 datasheet):
  989 TFLOP/s dense bf16 on the tensor cores; 67 TFLOP/s fp32 outside
  them (the port keeps TF32 off); 3.35 TB/s HBM3; 450 GB/s NVLink 4 in
  one direction.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict

import torch

from repro_torch.train.tree import tree_leaves

PEAK_FLOPS = 989e12        # dense bf16 / chip (tensor cores)
PEAK_FLOPS_FP32 = 67e12    # fp32 / chip, outside the tensor cores
HBM_BW = 3.35e12           # bytes/s / chip
# bytes/s / chip in one direction: NVLink 4's 900 GB/s both ways. The
# reference's figure is one link's; the NVSwitch fabric gives any peer
# the chip's whole one-direction rate, so that rate stands in for the
# link. Not measured (no multi-card run).
ICI_BW = 450e9

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1,
    "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# result shapes like:  bf16[8,512,128]{2,1,0}  or tuples (f32[...], f32[...])
_SHAPE_RE = re.compile(r"(bf16|f64|f32|f16|f8e4m3|f8e5m2|s64|s32|s16|s8|u64|"
                       r"u32|u16|u8|pred|c64|c128)\[([0-9,]*)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def parse_collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Sum result-shape bytes per collective op kind from HLO text."""
    out = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for line in hlo_text.splitlines():
        s = line.strip()
        # `x = bf16[...] all-gather(...)`: opcode appears right after the
        # result shape; skip fusion-comment mentions.
        m = re.search(r"=\s*(?:\([^)]*\)|\S+)\s+([a-z0-9-]+)\(", s)
        if not m:
            continue
        op = m.group(1)
        if op.rstrip("-start").rstrip("-done") in _COLLECTIVES or \
                any(op == c or op == c + "-start" for c in _COLLECTIVES):
            base = next((c for c in _COLLECTIVES if op.startswith(c)), None)
            if base is None or op.endswith("-done"):
                continue
            lhs = s.split("=")[0] + "= " + s.split("=", 1)[1].split(base)[0]
            out[base] += _shape_bytes(lhs)
            out["count"] += 1
    return out


@dataclasses.dataclass
class Roofline:
    """All byte/FLOP fields are GLOBAL (across chips); the three terms
    are t_x = global_quantity / (chips * per_chip_rate). ``peak_flops``
    is the rate of the step's compute dtype (``PEAK_FLOPS`` for bf16,
    ``PEAK_FLOPS_FP32`` for fp32)."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    n_chips: int
    model_flops: float = 0.0
    peak_flops: float = PEAK_FLOPS

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * self.peak_flops)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes / (self.n_chips * ICI_BW)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the chip's peak the step would sustain if it ran at
        the bound: (model_flops / t_bound) / (chips * peak)."""
        if self.t_bound == 0:
            return 0.0
        return (self.model_flops / self.t_bound) / (self.n_chips
                                                    * self.peak_flops)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def tree_bytes(tree) -> int:
    """Global bytes of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_bytes_read(params, reads) -> int:
    """Bytes a step reads of ``params``: all of them where ``reads`` is
    ``None``, else each key of ``reads`` (a cell's ``param_reads``) at the
    rows of its leading dimension given there (``None``: all), and no
    other key."""
    if reads is None:
        return tree_bytes(params)
    total = 0
    for key, rows in reads.items():
        t = params[key]
        if rows is None:
            total += tree_bytes(t)
        else:
            total += (min(rows, t.shape[0]) * (t.numel() // t.shape[0])
                      * t.element_size())
    return total


def from_cell(cell, n_chips: int) -> Roofline:
    """The roofline of a :class:`repro_torch.launch.cells.Cell` from its
    specs: ``flops`` its ``model_flops``; ``hbm_bytes`` the step's least
    traffic: every argument read once, the parameters only where the step
    reads them (a serving or retrieval step gathers a table at its ids'
    rows, one row an id, and reads no parameter its output does not need:
    the cell's ``param_reads``), plus, for a ``*_train`` cell, the
    parameters and optimizer state written once; no collective bytes (one
    process drives every shard); the peak of the cell's compute dtype
    (bf16 for the LMs, fp32 for the GNN and the recsys models)."""
    hbm = _param_bytes_read(cell.args[0], cell.meta.get("param_reads")) \
        + tree_bytes(cell.args[1:])
    if cell.kind.endswith("_train"):
        hbm += tree_bytes(cell.args[:2])
    peak = PEAK_FLOPS if cell.kind.startswith("lm_") else PEAK_FLOPS_FP32
    return Roofline(flops=float(cell.model_flops), hbm_bytes=float(hbm),
                    collective_bytes=0.0, n_chips=int(n_chips),
                    model_flops=float(cell.model_flops), peak_flops=peak)


def kernel_bound(nbytes: float, flops: float,
                 peak_flops: float = PEAK_FLOPS_FP32,
                 hbm_bw: float = HBM_BW):
    """The least time one card could take for work that moves ``nbytes``
    and does ``flops``: ``(ms, "bytes" or "operations")``, the larger of
    the bytes over ``hbm_bw`` and the operations over ``peak_flops``."""
    t_bytes = 1e3 * nbytes / hbm_bw
    t_ops = 1e3 * flops / peak_flops
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
