"""Attention: RoPE, GQA/MQA, the blocked online-softmax attention of
prefill, and the decode path over a KV cache.

Plain PyTorch, as the reference writes these in plain jnp (none of them
is a Pallas kernel there). The numerics are the reference's, dtype for
dtype: RoPE in fp32 cast back to the input's dtype; blocked attention's
scores in the compute dtype with an fp32 running max, sum and
accumulator; decode attention's scores and values accumulated in fp32
from operands of the cache's dtype (the reference asks XLA for fp32
outputs of bf16 operands; a PyTorch matmul of bf16 tensors returns bf16,
so the operands are upcast, which keeps every product exact).

KV heads map to query heads as ``jnp.repeat`` maps them: query head ``h``
reads KV head ``h // G`` with ``G = H // Hkv``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # large-negative instead of -inf: keeps softmax NaN-free


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: ``[..., S, H, D]``; positions: broadcastable to ``[..., S]``.
    The split-half rotation in fp32, cast back to ``x``'s dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # [D/2]
    angles = positions[..., None].float() * freqs                # [..., S, D/2]
    sin = torch.sin(angles)[..., None, :]                        # [..., S, 1, D/2]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Blocked (flash-style) attention for prefill
# ---------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """GQA: repeat KV heads to match query heads. k: ``[B, S, Hkv, D]``;
    each KV head is repeated ``G`` times in place (``jnp.repeat``)."""
    n_kv = k.shape[2]
    if n_kv == n_q_heads:
        return k
    return torch.repeat_interleave(k, n_q_heads // n_kv, dim=2)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    kv_block: int = 512,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention. q: ``[B, Sq, H, D]``; k/v: ``[B, Skv,
    Hkv, D]``.

    Loops over KV blocks carrying (acc, running max, running sum); the
    peak intermediate is ``[B, H, Sq, kv_block]``. The last block is
    padded with zeros at position -1, which the mask drops.
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(Skv, device=dev)

    n_blocks = -(-Skv // kv_block)
    pad = n_blocks * kv_block - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)

    qt = (q * scale).transpose(1, 2)                          # [B, H, Sq, D]
    kt = k.transpose(1, 2)                                    # [B, H, Skv', D]
    vt = v.transpose(1, 2)
    qpos = q_positions[None, None, :, None]

    # fp32 accumulator (flash-attention numerics)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        blk = slice(i * kv_block, (i + 1) * kv_block)
        kb, vb = kt[:, :, blk], vt[:, :, blk]
        posb = kv_positions[blk][None, None, None, :]
        s = qt @ kb.transpose(-1, -2)                         # [B,H,Sq,blk]
        mask = posb >= 0
        if causal:
            mask = mask & (posb <= qpos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = p.to(vb.dtype) @ vb
        acc = acc * alpha[..., None] + pv.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                    # [B, Sq, H, D]


# ---------------------------------------------------------------------------
# Decode attention (one new token against a KV cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cache_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """q: ``[B, 1, H, D]``; caches: ``[B, S, Hkv, D]``; cache_len:
    ``[B]`` valid positions of each row. Linear in S.

    GQA is a grouped product (q as ``[B, Hkv, G, D]``), so the KV heads
    are never repeated. Scores and the value sum accumulate in fp32 from
    the operands' values (the operands are upcast; see the module
    docstring).
    """
    B, _, H, D = q.shape
    S = k_cache.shape[1]
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / (D ** 0.5)
    q5 = (q * scale).reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", q5.float(), k_cache.float())
    if cache_len is not None:
        pos = torch.arange(S, device=q.device)[None, None, None, :]
        s = torch.where(pos < cache_len[:, None, None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = out / l
    return out.reshape(B, 1, H, D).to(q.dtype)
