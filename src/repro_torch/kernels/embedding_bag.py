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

**Gradients.** :func:`embedding_bag` and :func:`take_rows` are
``torch.autograd.Function`` objects whose forward is what they compute above
(the kernel on the card) and whose backward is the closed form in plain
PyTorch on either device, :func:`row_grad`: the output gradient of each
(bag, field) scattered into a dense ``[V, d]`` table gradient (divided by
``F`` in mean mode), an id in ``[-V, 0)`` at ``V + id``, an id outside
``[-V, V)`` adding nothing, as ``jax.grad`` of ``jnp.take`` scatters.
The reference has no backward kernel either: it differentiates its jnp
``take``. The scatter is deterministic: a stable sort of the rows, then a
segmented sum in a fixed order, where ``index_add_`` and the backward of
advanced indexing may add duplicate rows with atomics in an order that
changes from run to run on the card.

**Segment sums.** :func:`segment_sum` is ``jax.ops.segment_sum`` on
the same sort and segmented sum (:class:`Segments`, which
:func:`row_grad` calls too): ids outside ``[0, num_segments)`` are
dropped, and the gradient is a gather. The GNN's aggregations and
readout run on it (:mod:`repro_torch.models.gnn`).
"""

from __future__ import annotations

import dataclasses
import functools
import math

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


def _take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    V = table.shape[0]
    row = torch.where(ids < 0, ids + V, ids)
    valid = (row >= 0) & (row < V)
    rows = table[torch.where(valid, row, torch.zeros_like(row)).long()]
    return rows.masked_fill_(~valid[..., None], float("nan"))


@dataclasses.dataclass(frozen=True)
class Segments:
    """Segment ids sorted once, for any number of deterministic segmented
    sums over them (:func:`segments`): ``ids`` each position's segment
    (``num_segments`` for a dropped position: a sink row cut off at the
    end), ``order`` the stable sort of ``ids``, ``keys`` the sorted ids,
    ``rank`` each sorted position's place in its run of equal keys,
    ``last`` whether it ends its run, ``longest`` the longest run."""
    ids: torch.Tensor
    order: torch.Tensor
    keys: torch.Tensor
    rank: torch.Tensor
    last: torch.Tensor
    longest: int
    num_segments: int

    def sum_sorted(self, vals: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The ``[num_segments, d]`` sums in ``dtype`` of ``vals [n, d]``,
        whose rows are already in ``order``: each run of equal keys summed
        by a segmented doubling scan (``ceil(log2)`` of the longest run of
        elementwise steps, each adding the partial sum ``s`` places back
        within the run), whose order of additions depends on the ids
        alone, so the sums are bitwise the same on every device. The scan
        runs in place: ``vals`` is overwritten unless it is cast."""
        vals = vals.to(dtype)
        out = vals.new_zeros((self.num_segments + 1, vals.shape[1]))
        if self.keys.numel() == 0:
            return out[:self.num_segments]
        s = 1
        while s < self.longest:
            vals[s:] += torch.where((self.rank[s:] >= s)[:, None],
                                    vals[:-s], 0.0)
            s *= 2
        out[self.keys[self.last]] = vals[self.last]
        return out[:self.num_segments]

    def sum(self, data: torch.Tensor) -> torch.Tensor:
        """``jax.ops.segment_sum`` of ``data [n, ...]`` over these segments
        (a dropped position adds nothing), summed by :meth:`sum_sorted` in
        float64 and rounded once to ``data``'s dtype. The GNN's std
        aggregator takes ``sq / count - mean**2`` of two such sums, which
        cancels: fp32 partial sums in the scan's order put the PNA smoke
        config's gradients 4.3e-5 normwise from a float64 run, where
        XLA's sequential fp32 sums land 1.8e-6 from it and sums rounded
        once from float64 2.4e-6 (``tests/test_torch_gnn.py``)."""
        flat = data.reshape(data.shape[0], math.prod(data.shape[1:]))
        out = self.sum_sorted(flat[self.order], torch.float64)
        return out.to(data.dtype).reshape((self.num_segments,)
                                          + data.shape[1:])

    def gather(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows [num_segments, ...]`` at each position's segment, zeros
        at a dropped position: the transpose of :meth:`sum`."""
        pad = rows.new_zeros((1,) + rows.shape[1:])
        return torch.cat([rows, pad])[self.ids]


def segments(ids: torch.Tensor, num_segments: int) -> Segments:
    """:class:`Segments` of the flat ``ids`` into ``num_segments``
    segments; an id outside ``[0, num_segments)`` is dropped, as
    ``jax.ops.segment_sum`` drops it. One stable sort and one host read
    (the longest run)."""
    row = ids.reshape(-1).long()
    row = torch.where((row >= 0) & (row < num_segments), row, num_segments)
    keys, order = torch.sort(row, stable=True)
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = keys[1:] != keys[:-1]
    # each position's place in its run: minus its run's first position
    rank = pos - pos[new][torch.cumsum(new, 0) - 1] if n else pos
    last = torch.ones(n, dtype=torch.bool, device=keys.device)
    last[:-1] = new[1:]
    longest = int(rank.max()) + 1 if n else 0
    return Segments(row, order, keys, rank, last, longest, num_segments)


class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segs):
        ctx.segs = segs
        return segs.sum(data)

    @staticmethod
    def backward(ctx, grad):
        return ctx.segs.gather(grad), None


def segment_sum(data: torch.Tensor, segs: Segments) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments)`` for ``segs =
    segments(ids, num_segments)``, deterministic on every device: ids
    outside ``[0, num_segments)`` are dropped, the sums taken by
    :meth:`Segments.sum` (no atomics, so two passes on the card are
    bitwise equal), and the gradient a gather. One sort serves any number
    of sums over the same ids."""
    return _SegmentSum.apply(data, segs)


def row_grad(ids: torch.Tensor, V: int, src: torch.Tensor,
             per: int) -> torch.Tensor:
    """The dense ``[V, d]`` float32 sum, over every position ``n`` of the
    flat ``ids [N]``, of ``src[n // per]`` (``src [N // per, d]``) into
    row ``ids[n]`` (``V + id`` for an id in ``[-V, 0)``; an id outside
    ``[-V, V)`` adds nothing). Deterministic on every device: the rows
    are sorted stably and each run of equal rows summed by
    :meth:`Segments.sum_sorted`."""
    row = ids.reshape(-1).long()
    segs = segments(torch.where(row < 0, row + V, row), V)
    return segs.sum_sorted(src.float()[segs.order // per])


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.V = table.shape[0]
        return _take(table, ids)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        d = grad.shape[-1]
        return (row_grad(ids, ctx.V, grad.reshape(-1, d), 1).to(grad.dtype),
                None)


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with ``jnp.take``'s semantics: negative ids in
    ``[-V, 0)`` count from the end, other out-of-range ids give NaN rows.
    Never indexes out of range. Its gradient is :func:`row_grad`'s
    deterministic scatter."""
    return _TakeRows.apply(table, ids)


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """The kernel's function in plain PyTorch (materialises the gathered
    rows; sums in float32, divides by ``F`` in float32, then casts)."""
    _check(table, ids, mode)
    acc = take_rows(table, ids).float().sum(dim=1)
    if mode == "mean":
        acc = acc / ids.shape[1]
    return acc.to(table.dtype)


def embedding_bag_backward(grad: torch.Tensor, ids: torch.Tensor, V: int,
                           mode: str) -> torch.Tensor:
    """The table's float32 gradient ``[V, d]`` from the bags' ``grad
    [B, d]``: each bag's gradient (over ``F`` in mean mode) into the rows
    of its ids, by :func:`row_grad`."""
    g = grad.float()
    if mode == "mean":
        g = g / ids.shape[1]
    return row_grad(ids, V, g, ids.shape[1])


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, ids, mode):
        ctx.save_for_backward(ids)
        ctx.V, ctx.mode = table.shape[0], mode
        return _launch(table, ids, mode)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return (embedding_bag_backward(grad, ids, ctx.V, ctx.mode)
                .to(grad.dtype), None, None)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Per-bag sum or mean of table rows (see the module docstring),
    differentiable in ``table`` through :func:`embedding_bag_backward`.

    CPU tensors run :func:`embedding_bag_plain`; CUDA tensors launch the
    kernel on the current stream (``embedding_bag.launches`` counts
    launches) and raise on anything the kernel does not take.
    """
    _check(table, ids, mode)
    return _EmbeddingBag.apply(table, ids, mode)


def _launch(table: torch.Tensor, ids: torch.Tensor,
            mode: str) -> torch.Tensor:
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
