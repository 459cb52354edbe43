"""Mixture-of-Experts FFN with sort-based token dispatch, and its
expert-parallel form over a port mesh.

The reference's ``models/moe.py``. Dispatch uses the argsort formulation
(MegaBlocks-style, DESIGN.md §5): flatten the (token, expert)
assignments, sort them by expert, number each assignment within its
expert's group, place it in a fixed ``[E, capacity, D]`` buffer, run the
three expert GEMMs batched over experts, and combine with the gates.
Tokens beyond an expert's capacity are dropped (Switch behaviour) and
counted in ``drop_rate``.

Where the reference's arithmetic has another form here, the values are
the same:

* ``lax.top_k`` is :func:`repro_torch.core.naive.stable_topk` (equal
  probabilities rank the lower expert first) and ``argsort(stable=True)``
  is ``torch.sort(stable=True)``; ``searchsorted`` is left-sided in both;
* the buffer is filled through a slot -> token map (every dropped
  assignment writes the one drop slot, which is sliced off) and a gather
  of the slots' token rows, which are the rows the reference scatters;
* the combine is a gather: each assignment reads its slot's output,
  scaled by its gate (0 when dropped), back in token order, and a sum
  over a token's ``top_k`` assignments, where the reference scatter-adds
  them (``segment_sum``). The sum has another order (fp32: within 1e-5
  relative; bf16: a few bf16 ulps), and no atomics, so it is
  deterministic on the card too.

:func:`moe_ffn_ep` is the reference's ``shard_map`` expert-parallel
dispatch over a :class:`repro_torch.core.mesh.Mesh` passed explicitly:
each (dp row, tp shard) pair of the mesh routes its row's tokens and
runs its ``E / tp`` experts; the pairs that share a device run as one
batched op with leading ``[rows, shards]`` dimensions, and the ``psum``
over tp is a sum over the shard dimension, in the activations' dtype.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.mesh import Mesh, shard_groups, take_shards
from repro_torch.core.naive import stable_topk
from repro_torch.models.common import (ACTIVATIONS, DEFAULT_RULES, MeshRules,
                                       dense_init)


class MoEParams(NamedTuple):
    router: torch.Tensor   # [D, E]
    w_gate: torch.Tensor   # [E, D, F]
    w_up: torch.Tensor     # [E, D, F]
    w_down: torch.Tensor   # [E, F, D]


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, device=None) -> MoEParams:
    """Random fp32 expert weights drawn from ``generator`` (LeCun-normal
    over each matrix's fan-in), on ``device`` (``None`` = ``cuda``)."""
    dev = resolve_device(device)
    shapes = ((d_model, n_experts), (n_experts, d_model, d_ff),
              (n_experts, d_model, d_ff), (n_experts, d_ff, d_model))
    return MoEParams(*(dense_init(generator, s).to(dev) for s in shapes))


def expert_capacity(n_tokens: int, top_k: int, capacity_factor: float,
                    n_experts: int) -> int:
    """Slots an expert for ``n_tokens`` routed tokens, rounded up to a
    multiple of 8."""
    capacity = max(int(n_tokens * top_k * capacity_factor / n_experts), 1)
    return -(-capacity // 8) * 8


def _route(logits: torch.Tensor, top_k: int):
    """fp32 router logits ``[..., T, E]`` -> ``(gates [..., T, k], expert
    ids [..., T, k], aux loss [...])``: softmax, the stable top-k, the
    gates renormalised, and the Switch load-balancing loss (eq. 4)."""
    E = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = stable_topk(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    me = probs.mean(-2)
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(-2)
    return gate_vals, expert_ids, E * (me * ce).sum(-1)


def _experts(buf: torch.Tensor, w_gate, w_up, w_down, act: str,
             eq_in: str, eq_out: str) -> torch.Tensor:
    """The gated expert FFN over a capacity buffer, in its dtype."""
    dt = buf.dtype
    fn = ACTIVATIONS[act]
    g = torch.einsum(eq_in, buf, w_gate.to(dt))
    u = torch.einsum(eq_in, buf, w_up.to(dt))
    return torch.einsum(eq_out, fn(g) * u, w_down.to(dt))


def moe_ffn(params: MoEParams, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            rules: MeshRules = DEFAULT_RULES
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: ``[T, D]`` flattened tokens -> ``(out [T, D], aux)``. ``aux``
    holds the fp32 scalars ``aux_loss`` and ``drop_rate``, as the
    reference's does, and the routing: ``expert_ids [T, top_k]`` and the
    fp32 ``router_logits [T, E]`` they were chosen from. Routing
    runs in fp32; the buffer and the GEMMs in ``x``'s dtype. ``rules``
    is the reference's and places nothing here."""
    T, D = x.shape
    E = params.router.shape[1]
    capacity = expert_capacity(T, top_k, capacity_factor, E)
    n_slots = E * capacity

    logits = x.float() @ params.router.float()                    # [T, E]
    gate_vals, expert_ids, aux_loss = _route(logits, top_k)

    # --- sort-based dispatch ----------------------------------------------
    N = T * top_k
    flat_e = expert_ids.reshape(-1)
    se, sort_idx = torch.sort(flat_e, stable=True)
    st = sort_idx // top_k                        # flat_t[sort_idx]
    group_start = torch.searchsorted(
        se, torch.arange(E, device=x.device, dtype=se.dtype))
    pos = torch.arange(N, device=x.device) - group_start[se]
    keep = pos < capacity
    dst = torch.where(keep, se * capacity + pos, n_slots)      # drop slot

    tok = torch.full((n_slots + 1,), T, dtype=torch.long, device=x.device)
    tok[dst] = st
    tok = tok[:n_slots]
    buf = (x[tok.clamp(max=T - 1)] * (tok < T)[:, None].to(x.dtype)
           ).reshape(E, capacity, D)

    # --- batched expert GEMMs ----------------------------------------------
    y = _experts(buf, params.w_gate, params.w_up, params.w_down, act,
                 "ecd,edf->ecf", "ecf,efd->ecd").reshape(n_slots, D)

    # --- combine: each assignment's slot output, back in token order -------
    slot = torch.empty_like(dst)
    slot[sort_idx] = dst
    kept = (slot < n_slots)[:, None]
    contrib = torch.where(kept, y[slot.clamp(max=n_slots - 1)],
                          y.new_zeros(())) \
        * gate_vals.reshape(-1, 1).to(y.dtype)
    out = contrib.reshape(T, top_k, D).sum(1)
    drop_rate = 1.0 - keep.float().mean()
    return out.to(x.dtype), {"aux_loss": aux_loss, "drop_rate": drop_rate,
                             "expert_ids": expert_ids,
                             "router_logits": logits}


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a mesh
# ---------------------------------------------------------------------------


def ep_available(n_experts: int, rules: MeshRules,
                 mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` has the tp axis and it divides the experts."""
    if mesh is None or rules.tp not in mesh.axis_names:
        return False
    return n_experts % mesh.shape[rules.tp] == 0


def _grid(shards: Sequence[int], tp_size: int):
    """A device's (dp row, tp shard) pairs as one ``(rows, cols)`` grid of
    contiguous runs, as every device's pairs are on a mesh whose device
    list repeats each device in one block (all shards on one card, or one
    shard a card). Raises ``ValueError`` on any other layout."""
    pairs = [divmod(i, tp_size) for i in shards]
    rows = sorted({r for r, _ in pairs})
    cols = sorted({j for _, j in pairs})
    if len(pairs) != len(rows) * len(cols) \
            or rows != list(range(rows[0], rows[0] + len(rows))) \
            or cols != list(range(cols[0], cols[0] + len(cols))):
        raise ValueError(f"moe_ffn_ep: a device's (dp row, tp shard) "
                         f"pairs {pairs} are not a contiguous grid")
    return rows, cols


def _ep_block(router, w_gate, w_up, w_down, x, cols, E, top_k,
              capacity_factor, act):
    """One device's grid of pairs: ``x [R, T_l, D]`` (its dp rows' tokens),
    expert weights ``[J, E_local, ...]`` of its tp shards ``cols``.
    Returns ``(partial [R, J, T_l, D], aux [R], kept [R, J],
    expert_ids [R, T_l, top_k], router logits [R, T_l, E])``."""
    R, T_l, D = x.shape
    J, E_local = w_gate.shape[:2]
    dev = x.device
    capacity = expert_capacity(T_l, top_k, capacity_factor, E)
    n_slots = E_local * capacity
    N = T_l * top_k

    # route in the compute dtype, the logits upcast (as the reference's EP
    # path routes, unlike moe_ffn)
    logits = (x @ router.to(x.dtype)).float()                   # [R, T_l, E]
    gate_vals, expert_ids, aux = _route(logits, top_k)

    e_first = torch.tensor(cols, device=dev)[None, :, None] * E_local
    local_e = expert_ids.reshape(R, 1, N) - e_first             # [R, J, N]
    is_local = (local_e >= 0) & (local_e < E_local)
    le = torch.where(is_local, local_e, E_local)             # dump bucket
    se, sort_idx = torch.sort(le, dim=-1, stable=True)
    st_tok = sort_idx // top_k
    group_start = torch.searchsorted(
        se, torch.arange(E_local, device=dev, dtype=se.dtype)
        .expand(R, J, E_local).contiguous())
    pos = torch.arange(N, device=dev) - group_start.gather(
        -1, se.clamp(max=E_local - 1))
    keep = (se < E_local) & (pos < capacity)
    dst = torch.where(keep, se * capacity + pos, n_slots)

    tok = torch.full((R, J, n_slots + 1), T_l, dtype=torch.long,
                     device=dev).scatter_(-1, dst, st_tok)[..., :n_slots]
    valid = (tok < T_l).to(x.dtype)[..., None]
    rows = torch.arange(R, device=dev)[:, None, None]
    buf = (x[rows, tok.clamp(max=T_l - 1)] * valid).reshape(
        R, J, E_local, capacity, D)

    y = _experts(buf, w_gate, w_up, w_down, act, "rjecd,jedf->rjecf",
                 "rjecf,jefd->rjecd").reshape(R, J, n_slots, D)

    # combine: each assignment local to the shard reads its slot's output
    # times its gate; the shard's partial sums a token's assignments
    slot = torch.empty_like(dst).scatter_(-1, sort_idx, dst)
    kept_slot = (slot < n_slots)[..., None]
    gates = gate_vals.reshape(R, 1, N, 1).to(x.dtype)
    contrib = torch.where(
        kept_slot,
        y.gather(2, slot.clamp(max=n_slots - 1)[..., None].expand(
            R, J, N, D)),
        y.new_zeros(())) * gates
    partial = contrib.reshape(R, J, T_l, top_k, D).sum(3)
    return partial, aux, keep.float().mean(-1), expert_ids, logits


def moe_ffn_ep(params: MoEParams, h: torch.Tensor, top_k: int,
               capacity_factor: float = 1.25, act: str = "silu",
               rules: MeshRules = DEFAULT_RULES,
               mesh: Optional[Mesh] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Expert-parallel MoE over ``mesh``: h ``[B, S, D]`` -> ``(out
    [B, S, D], aux)``, ``aux`` as :func:`moe_ffn`'s.

    The batch splits over the dp axes (contiguous rows, first axis
    major; when they do not divide ``B`` the tokens are one row, as the
    reference replicates tiny decode batches), the experts over tp. Each
    (row, shard) pair routes its row's tokens LOCALLY and fills the
    capacity buffer of its ``E / tp`` experts only; capacity is per (row,
    expert). ``out`` sums the shards' partials in ``h``'s dtype;
    ``aux_loss`` is the mean of the rows' losses and ``drop_rate`` the
    mean over rows of ``1 - `` the shards' summed kept shares. Raises
    ``ValueError`` without a mesh that takes EP, or when a device's
    (row, shard) pairs are not a contiguous grid.
    """
    E = params.router.shape[1]
    if not ep_available(E, rules, mesh):
        raise ValueError(f"moe_ffn_ep needs a mesh whose {rules.tp!r} axis "
                         f"divides the {E} experts, got {mesh}")
    tp = rules.tp
    tp_size = mesh.shape[tp]
    dp = rules.dp_axes(mesh)
    dp_size = math.prod(mesh.shape[a] for a in dp)
    B, S, D = h.shape
    if B % dp_size != 0:
        dp, dp_size = (), 1    # tiny decode batches: tokens one row
    E_local = E // tp_size
    T_l = (B // dp_size) * S
    x_rows = h.reshape(dp_size, T_l, D)
    w = [t.reshape((tp_size, E_local) + tuple(t.shape[1:]))
         for t in (params.w_gate, params.w_up, params.w_down)]

    lead = h.device
    partial: Dict[Tuple[int, int], torch.Tensor] = {}
    kept: Dict[Tuple[int, int], torch.Tensor] = {}
    aux: Dict[int, torch.Tensor] = {}
    ids: Dict[int, torch.Tensor] = {}
    logits: Dict[int, torch.Tensor] = {}
    for g in shard_groups(mesh, dp + (tp,)):
        rows, cols = _grid(g.shards, tp_size)
        p, a, k, e, lg = _ep_block(
            params.router.to(g.device),
            *(take_shards(t, cols).to(g.device) for t in w),
            take_shards(x_rows, rows).to(g.device), cols, E, top_k,
            capacity_factor, act)
        for ri, r in enumerate(rows):
            aux.setdefault(r, a[ri].to(lead))
            ids.setdefault(r, e[ri].to(lead))
            logits.setdefault(r, lg[ri].to(lead))
            for ci, j in enumerate(cols):
                partial[r, j] = p[ri, ci].to(lead)
                kept[r, j] = k[ri, ci].to(lead)
    out = torch.stack([
        torch.stack([partial[r, j] for j in range(tp_size)]).sum(0)
        for r in range(dp_size)])                               # psum over tp
    aux_loss = torch.stack([aux[r] for r in range(dp_size)]).sum() / dp_size
    drop = torch.stack([1.0 - torch.stack([kept[r, j]
                                           for j in range(tp_size)]).sum()
                        for r in range(dp_size)]).sum() / dp_size
    return out.reshape(B, S, D).to(h.dtype), {
        "aux_loss": aux_loss, "drop_rate": drop,
        "expert_ids": torch.cat([ids[r] for r in range(dp_size)])
        .reshape(B * S, top_k),
        "router_logits": torch.cat([logits[r] for r in range(dp_size)])
        .reshape(B * S, E)}
