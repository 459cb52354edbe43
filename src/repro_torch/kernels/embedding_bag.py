"""Fixed-arity EmbeddingBag: the CUDA kernel's wrapper and its plain
PyTorch version.

``embedding_bag(table, ids, mode)`` reduces the table rows of each bag,
``table [V, d]`` (float32 or float16) and ``ids [B, F]`` int32 ->
``[B, d]`` in the table's dtype: their sum (``mode="sum"``) or their sum
divided by ``F`` (``"mean"``), accumulated in float32. It is the recsys
hot path: the query tower's field mean and the first-order term's sum
over the linear weights (viewed as a ``[V, 1]`` table) in
:mod:`repro_torch.models.recsys`. The kernel never materialises the
gathered ``[B, F, d]`` rows. :func:`launch_plan` picks its path by shape:
at ``d = 1`` a lane per bag, whose warp stages its 32 bags' ids in shared
memory; otherwise a thread per (bag, column) output.

Ids follow ``jnp.take``, as the reference's oracle and models do: an id
in ``[-V, 0)`` counts from the end of the table, and any id outside
``[-V, V)`` reads nothing and makes its bag NaN.

This is the counterpart of the reference's ``kernels/ops.py:
embedding_bag``, which pads the batch to a multiple of ``block_b`` for
the Pallas grid and slices the result back; that padding and the
``block_b``/``interpret`` knobs are Pallas details the port leaves out.
:func:`embedding_bag` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches ``csrc/embedding_bag.cu`` or raises.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

MODES = ("sum", "mean")
DTYPES = (torch.float32, torch.float16)
# a block's threads and warps (csrc/embedding_bag.cu)
THREADS = 256
WARPS = THREADS // 32
#: At d = 1 a block stages at most this many 4-byte ids in shared memory
#: (two buffers a warp, one in flight while the other is read).
SMEM_WORDS = 12288


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    path: str             # "bags" (d = 1: a lane a bag) or "cols"
    fields: int           # bags path: fields a chunk (F when one holds all)
    buf_words: int        # bags path: words of one of a warp's two buffers
    smem: int             # dynamic shared-memory bytes a block
    tasks: int            # bags path: warps' tasks (32 bags); cols: blocks


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, F: int, d: int) -> LaunchPlan:
    """How the kernel runs ``[B, F]`` ids over a ``[V, d]`` table. At
    ``d = 1`` (and ``F > 0``) the *bags* path: a warp's task is 32 bags, a
    lane each, whose ids it stages ``FC`` fields at a time, each bag's in a
    row of ``FC | 1`` words: as many fields as let a block's 8 warps x 2
    buffers fit :data:`SMEM_WORDS`. Otherwise the *cols* path: a thread per
    (bag, column) output, :data:`THREADS` a block."""
    if d != 1 or F == 0:
        return LaunchPlan("cols", 0, 0, 0, -(-B * d // THREADS))
    words = SMEM_WORDS // (2 * WARPS)        # a buffer, with 3 for a shift
    FC = min(F, (words - 6) // 32)
    while FC > 1 and 32 * (FC | 1) + 6 > words:
        FC -= 1
    buf = (32 * (FC | 1) + 3 + 3) & ~3
    return LaunchPlan("bags", FC, buf, 4 * 2 * WARPS * buf, -(-B // 32))


def _check(table: torch.Tensor, ids: torch.Tensor, mode: str) -> None:
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"pass table [V, d] and ids [B, F]; got table "
                         f"{tuple(table.shape)} and ids {tuple(ids.shape)}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if table.device != ids.device:
        raise ValueError("table and ids must be on one device")


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s semantics: negative ids in
    ``[-V, 0)`` count from the end, other out-of-range ids give NaN rows.
    Never indexes out of range."""
    V = table.shape[0]
    row = torch.where(ids < 0, ids + V, ids)
    valid = (row >= 0) & (row < V)
    rows = table[torch.where(valid, row, torch.zeros_like(row)).long()]
    return rows.masked_fill_(~valid[..., None], float("nan"))


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """The kernel's function in plain PyTorch (materialises the gathered
    rows; sums in float32, divides by ``F`` in float32, then casts)."""
    _check(table, ids, mode)
    acc = take_rows(table, ids).float().sum(dim=1)
    if mode == "mean":
        acc = acc / ids.shape[1]
    return acc.to(table.dtype)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Per-bag sum or mean of table rows (see the module docstring).

    CPU tensors run :func:`embedding_bag_plain`; CUDA tensors launch the
    kernel on the current stream (``embedding_bag.launches`` counts
    launches) and raise on anything the kernel does not take.
    """
    _check(table, ids, mode)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, mode)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype not in DTYPES or ids.dtype != torch.int32:
        raise ValueError("table must be float32 or float16, ids int32")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("operands must be contiguous")
    (V, d), (B, F) = table.shape, ids.shape
    if V >= 2 ** 31:
        raise ValueError(f"kernel limits: V < 2**31 rows (got {V})")
    out = torch.empty((B, d), dtype=table.dtype, device=table.device)
    if B == 0 or d == 0:
        return out
    plan = launch_plan(B, F, d)
    from repro_torch.kernels._build import load
    lib = load("embedding_bag")
    with torch.cuda.device(table.device):
        err = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), B, F, V, d,
            int(mode == "mean"), int(table.dtype == torch.float16),
            int(plan.path == "bags"), plan.fields, plan.buf_words,
            torch.cuda.current_stream(table.device).cuda_stream)
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err} "
                           f"({msg})")
    embedding_bag.launches += 1
    return out


#: Launches of the CUDA kernel in this process (plain-version calls on
#: CPU tensors are not launches). Callers reset it to 0 to count a run.
embedding_bag.launches = 0
