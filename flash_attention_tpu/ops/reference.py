"""fp32 reference ("oracle") attention.

Re-design of the reference's CPU oracle ``cpu_attention``
(flash_attention.cu:668-697): a naive, fully-materialized attention with fp32
accumulation used as the correctness judge for every fused kernel. The numerics
contract is identical — fp32 score accumulation, softmax with a subtracted row
max, fp32 weighted-V sum, final cast to the I/O dtype — with two generalizations
the CUDA oracle lacked: grouped-query (GQA/MQA) head broadcasting and explicit
per-sequence length masking (used by the decode/KV-cache paths).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# The reference masks with -10000, not -inf (flash_attention.cu:238). We keep a
# large-but-finite constant for the same reason (no NaN from exp(-inf - -inf))
# but scale it to fp32 range since our scores are fp32.
DEFAULT_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)


def reference_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    kv_length: jax.Array | None = None,
    out_dtype=None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    segment_ids=None,
) -> jax.Array:
    """Naive fp32 attention over [batch, heads, seq, head_dim] inputs.

    Args:
      q: [B, Hq, Sq, D] queries (any float dtype; computed in fp32).
      k: [B, Hkv, Skv, D] keys. Hq must be a multiple of Hkv (GQA).
      v: [B, Hkv, Skv, D] values.
      causal: apply lower-triangular mask (query i attends to keys j <= i,
        aligned at the END of the KV sequence when Sq != Skv, which is the
        decode convention).
      sm_scale: softmax scale; defaults to 1/sqrt(D) (flash_attention.cu:612).
      kv_length: optional [B] int32 — valid KV prefix length per batch element.
      out_dtype: output dtype; defaults to q.dtype.
      segment_ids: packed-sequence ids — one [B, S] array (self-attention) or
        a (q_ids [B, Sq], kv_ids [B, Skv]) pair; attention only within equal
        ids.

    Returns:
      [B, Hq, Sq, D] attention output.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, heads, seq, head_dim] inputs")
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"Hq={num_q_heads} not a multiple of Hkv={num_kv_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / (head_dim**0.5)
    if sliding_window is not None and not causal:
        # Match the fused kernel's contract (flash_attention raises too) —
        # silently computing FULL attention here would make the oracle bless
        # a config the kernel rejects.
        raise ValueError("sliding_window requires causal=True")
    if out_dtype is None:
        out_dtype = q.dtype

    group = num_q_heads // num_kv_heads
    qf = q.astype(jnp.float32)
    kf = jnp.repeat(k.astype(jnp.float32), group, axis=1)
    vf = jnp.repeat(v.astype(jnp.float32), group, axis=1)

    scores = jnp.einsum("bhqd,bhkd->bhqk", qf, kf, precision=jax.lax.Precision.HIGHEST) * sm_scale
    if logit_softcap is not None:
        scores = logit_softcap * jnp.tanh(scores / logit_softcap)

    mask = None
    if causal:
        # Decode convention: the last query row aligns with the last KV row.
        row = jnp.arange(q_len)[:, None] + (kv_len - q_len)
        col = jnp.arange(kv_len)[None, :]
        mask = col <= row  # [Sq, Skv]
        if sliding_window is not None:
            mask = mask & (col > row - sliding_window)
        mask = mask[None, None]
    if kv_length is not None:
        len_mask = jnp.arange(kv_len)[None, :] < kv_length[:, None]  # [B, Skv]
        len_mask = len_mask[:, None, None, :]
        mask = len_mask if mask is None else (mask & len_mask)
    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            sq_ids, skv_ids = segment_ids
        else:
            sq_ids = skv_ids = segment_ids
        seg_mask = (sq_ids[:, :, None] == skv_ids[:, None, :])[:, None]
        mask = seg_mask if mask is None else (mask & seg_mask)
    if mask is not None:
        scores = jnp.where(mask, scores, DEFAULT_MASK_VALUE)

    weights = jax.nn.softmax(scores, axis=-1)
    if mask is not None:
        # Fully-masked rows (zero-length KV slots, dead packed-segment rows)
        # emit ZEROS — the kernels' l == 0 guard (ops/common.py) — where bare
        # softmax over uniformly-masked scores would return the unweighted
        # mean of V.
        any_live = jnp.any(mask, axis=-1, keepdims=True)
        weights = jnp.where(any_live, weights, 0.0)
    out = jnp.einsum("bhqk,bhkd->bhqd", weights, vf, precision=jax.lax.Precision.HIGHEST)
    return out.astype(out_dtype)


def reference_attention_with_lse(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    kv_length: jax.Array | None = None,
):
    """Like :func:`reference_attention` but also returns the base-2 LSE.

    The log-sum-exp is returned in the base-2 domain — ``max + log2(sum)`` of
    ``2^(scores*log2e - max)`` — matching the (m, l) contract of the split-KV
    merge primitive (the reference merge kernel also works in the exp2 domain,
    flash_attention.cu:584-592).
    """
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    group = num_q_heads // num_kv_heads
    qf = q.astype(jnp.float32)
    kf = jnp.repeat(k.astype(jnp.float32), group, axis=1)
    vf = jnp.repeat(v.astype(jnp.float32), group, axis=1)

    log2e = 1.4426950408889634
    s2 = jnp.einsum("bhqd,bhkd->bhqk", qf, kf, precision=jax.lax.Precision.HIGHEST) * (sm_scale * log2e)

    mask = None
    if causal:
        row = jnp.arange(q_len)[:, None] + (kv_len - q_len)
        col = jnp.arange(kv_len)[None, :]
        mask = (col <= row)[None, None]
    if kv_length is not None:
        len_mask = (jnp.arange(kv_len)[None, :] < kv_length[:, None])[:, None, None, :]
        mask = len_mask if mask is None else (mask & len_mask)
    if mask is not None:
        s2 = jnp.where(mask, s2, DEFAULT_MASK_VALUE)

    m = jnp.max(s2, axis=-1)
    p = jnp.exp2(s2 - m[..., None])
    l = jnp.sum(p, axis=-1)
    out = jnp.einsum("bhqk,bhkd->bhqd", p, vf, precision=jax.lax.Precision.HIGHEST) / l[..., None]
    lse2 = m + jnp.log2(l)
    if mask is not None:
        # Fully-masked rows: out 0 and lse2 = -inf (the empty-range marker
        # merge_partial_attention and the kernels use), not a huge finite
        # negative from the mask constant.
        any_live = jnp.any(mask, axis=-1)
        out = jnp.where(any_live[..., None], out, 0.0)
        lse2 = jnp.where(any_live, lse2, -jnp.inf)
    return out.astype(q.dtype), lse2
