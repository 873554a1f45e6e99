"""Partial-attention merge primitive (log-sum-exp combine).

Re-design of the reference's split-K merge kernel C5
(``flash_attention_splitk_merge``, flash_attention.cu:559-598): given partial
attention outputs computed over disjoint KV ranges, combine them into the
exact full-attention result. The reference carried per-split (m, l) pairs and
worked in the exp2 domain (flash_attention.cu:584-592); we fold (m, l) into a
single base-2 log-sum-exp per row — ``lse2 = m + log2(l)`` — which is the
residual the forward/decode kernels already emit.

This one primitive serves three consumers (SURVEY.md §3.4):
  * flash-decoding: KV-split partials merged per chip,
  * sequence/context parallelism: per-chip partials merged across the mesh,
  * ring attention: the per-step running combine.

It is spec'd and unit-tested against the oracle — the reference's merge path
was dead code and never tested (SURVEY.md §4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def merge_partial_attention(
    o_parts: jax.Array,
    lse_parts: jax.Array,
    *,
    axis: int = 0,
):
    """Merge normalized partial attention outputs.

    Args:
      o_parts: [..., q, d] partial outputs stacked along ``axis``; each part
        is softmax(QKᵀ over its KV range)·V, i.e. already normalized by its
        own l (the kernels' standard output).
      lse_parts: matching base-2 log-sum-exp per row, same stacking; shape of
        ``o_parts`` minus the trailing d dimension. Rows with ``-inf`` mark
        empty KV ranges (zero-length splits) and contribute nothing.
      axis: the stacking axis, as a position in ``o_parts``. Negative values
        are normalized against o_parts' rank (lse_parts has one fewer dim, so
        a raw negative axis would name DIFFERENT dims in the two arrays —
        e.g. -3 is the split axis of [B, s, q, d] but the batch axis of
        [B, s, q]).

    Returns:
      (o, lse2): merged output (same dtype as o_parts) with the split axis
      removed, and the merged base-2 LSE.
    """
    axis = range(o_parts.ndim)[axis]  # normalize (raises on out-of-range)
    if axis >= lse_parts.ndim:
        raise ValueError(
            f"axis {axis} must index a shared leading dim; lse_parts has "
            f"rank {lse_parts.ndim}"
        )
    if lse_parts.shape != o_parts.shape[:-1]:
        raise ValueError(
            f"lse_parts shape {lse_parts.shape} != o_parts shape minus d "
            f"{o_parts.shape[:-1]}"
        )
    o_parts = jnp.moveaxis(o_parts, axis, 0)
    lse_parts = jnp.moveaxis(lse_parts, axis, 0)

    m = jnp.max(lse_parts, axis=0)  # [..., q]
    # Guard fully-empty rows (all splits -inf): exp2(-inf - -inf) would be NaN.
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.exp2(lse_parts - m_safe)  # [s, ..., q]; empty splits -> 0
    denom = jnp.sum(w, axis=0)  # [..., q]
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    o = jnp.einsum(
        "s...q,s...qd->...qd",
        (w / denom_safe).astype(jnp.float32),
        o_parts.astype(jnp.float32),
    )
    lse2 = jnp.where(denom == 0.0, -jnp.inf, m + jnp.log2(denom_safe))
    return o.astype(o_parts.dtype), lse2


def merge_two(o_a, lse_a, o_b, lse_b):
    """Running two-way combine (the ring-attention inner step).

    Equivalent to :func:`merge_partial_attention` on two parts but avoids the
    stack; accumulator-friendly (call repeatedly with the running result).
    """
    m = jnp.maximum(lse_a, lse_b)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    wa = jnp.exp2(lse_a - m_safe)
    wb = jnp.exp2(lse_b - m_safe)
    denom = wa + wb
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    o = (
        wa[..., None].astype(jnp.float32) * o_a.astype(jnp.float32)
        + wb[..., None].astype(jnp.float32) * o_b.astype(jnp.float32)
    ) / denom_safe[..., None]
    lse2 = jnp.where(denom == 0.0, -jnp.inf, m + jnp.log2(denom_safe))
    return o.astype(o_a.dtype), lse2
