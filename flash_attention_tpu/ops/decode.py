"""Decode attention: single-token queries against a (possibly quantized) KV
cache, with per-sequence lengths — flash-decoding.

This is the first-class productionization of the reference's *latent* split-K
path (C4g/C5, flash_attention.cu:169-180, 460-496, 559-598): the CUDA kernel
could emit per-split (O, m, l) partials and a merge kernel existed, but the
dispatcher never used them (SURVEY.md §2 "IS_SPLITK always false"). Here the
same math is live:

  * :func:`decode_attention` attends one query row per head over the cache
    and can emit the base-2 LSE residual,
  * :func:`flash_attention_tpu.ops.merge.merge_partial_attention` is the
    reference's merge math (exp2-domain weights, flash_attention.cu:584-592),
  * :func:`decode_attention_split` = flash-decoding (KV-range splits merged
    with the LSE); the identical merge combines cross-device partials for
    sequence-parallel serving.

The dense cache is contiguous, so the decode step is plain ``jnp`` in one
jit: XLA fuses the dequantization into the two GEMV-shaped contractions and
the masked exp2 softmax between them. GQA grouping uses the "commute the sum"
trick (q heads sharing a KV head are the rows of one contraction) — the
equivalent of the reference packing 16 Q rows per warp
(flash_attention.cu:114-117).

Quantized KV caches (int8 / fp8 with per-token scales, ops/quant.py) are
dequantized late: per-token scales commute with the dot, so they multiply
the [group, seq] score rows and the probabilities instead of the [seq, D]
payload, which is read once at its stored width.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from flash_attention_tpu.ops.common import LOG2E, MASK_VALUE, M_FLOOR, ceil_to
from flash_attention_tpu.ops.merge import merge_partial_attention
from flash_attention_tpu.ops.quant import QuantizedTensor
from flash_attention_tpu.ops.tuning import select_decode_block_sizes


def _split_quant(x):
    if isinstance(x, QuantizedTensor):
        return x.values, x.scales
    return x, None


def should_split_decode(
    batch: int, num_kv_heads: int, max_seq: int, block_kv: int
) -> int:
    """Flash-decoding heuristic for OPT-IN callers: 0 = no split.

    Splitting the KV range multiplies the independent work items — the
    reference's latent grid.z split-K (flash_attention.cu:174-176), which
    fills idle SMs when batch x kv_heads is small and the context is long.
    The split costs one re-layout copy of the cache per call, so it stays
    OFF by default (decode_attention(..., auto_split=False)); the same split
    + LSE-merge math is live across devices in sequence-parallel serving
    (parallel/).
    """
    if batch * num_kv_heads > 16 or max_seq < 8192:
        return 0
    max_by_len = max(1, max_seq // (2 * block_kv))
    splits = min(4, max_by_len)
    while splits > 1 and max_seq % splits:
        splits -= 1
    return splits if splits > 1 else 0


def _visible(lengths, max_seq, *, window, ring_buffer, sinks):
    """[B, S] mask of the cache slots the current token attends to."""
    col = jnp.arange(max_seq, dtype=jnp.int32)[None, :]
    length = lengths[:, None]
    if ring_buffer and sinks:
        # StreamingLLM two-region layout: slots [0, sinks_pad) hold
        # positions [0, sinks) verbatim (always attended); the ring occupies
        # the rest with modulus max_seq - sinks_pad over positions >= sinks.
        # Slots whose reconstructed position falls below `sinks` are empty.
        sinks_pad = ceil_to(sinks, 128)
        ring_mod = max_seq - sinks_pad
        sink_ok = jnp.logical_and(col < sinks, col < length)
        pos = length - 1 - jnp.remainder(
            length - 1 - sinks - (col - sinks_pad), ring_mod
        )
        ring_ok = pos >= jnp.maximum(sinks, length - window)
        return jnp.where(col < sinks_pad, sink_ok, ring_ok)
    if ring_buffer:
        # Slot col holds the largest position p < length with p == col (mod
        # max_seq). Empty slots (length <= max_seq, col >= length) come out
        # negative and fail the window bound. Keys carry RoPE applied at
        # write time and attention is permutation-invariant, so masking by
        # reconstructed position is all a ring layout needs.
        pos = length - 1 - jnp.remainder(length - 1 - col, max_seq)
        return pos >= jnp.maximum(0, length - window)
    ok = col < length
    if window is not None:
        ok = jnp.logical_and(ok, col >= length - window)
    return ok


@functools.partial(
    jax.jit,
    static_argnames=(
        "sm_scale", "block_kv", "save_residuals", "interpret",
        "sliding_window", "logit_softcap", "auto_split", "d64_unpadded",
        "ring_buffer", "attention_sinks",
    ),
)
def decode_attention(
    q: jax.Array,
    k_cache,
    v_cache,
    lengths: jax.Array,
    *,
    sm_scale: float | None = None,
    block_kv: int | None = None,
    save_residuals: bool = False,
    interpret: bool | None = None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    auto_split: bool = False,
    d64_unpadded: bool = False,
    ring_buffer: bool = False,
    attention_sinks: int = 0,
):
    """Single-token decode attention over a KV cache.

    Args:
      q: [batch, q_heads, head_dim] current-token queries.
      k_cache, v_cache: [batch, kv_heads, max_seq, head_dim] — either plain
        arrays (bf16/fp16/fp32) or :class:`QuantizedTensor` (int8/fp8 payload
        + [batch, kv_heads, max_seq, 1] fp32 per-token scales), dequantized
        inside the fused step.
      lengths: [batch] int32 — valid KV prefix per sequence (the new token's
        K/V must already be written at position lengths-1).
      block_kv: split unit of the flash-decoding gate (a positive multiple of
        128; stepped down to a divisor of the 128-padded cache length).
      save_residuals: also return base-2 LSE [batch, q_heads] for cross-device
        or split merging.
      interpret: accepted for interface stability; this op has no kernel.
      auto_split: opt-in dispatch to :func:`decode_attention_split`
        (flash-decoding) per :func:`should_split_decode`.
      d64_unpadded: accepted for interface stability; head_dim is never
        padded here.
      ring_buffer: the cache is a ROLLING buffer (Mistral-class local
        attention): position p lives at slot p % max_seq and `lengths`
        counts TOTAL positions written (it may exceed max_seq). Requires
        sliding_window <= max_seq (the buffer must hold the whole window)
        and a 128-multiple max_seq. Memory stays O(window) however long the
        sequence runs.
      attention_sinks: with ring_buffer, the first ``attention_sinks``
        positions stay pinned in slots [0, ceil128(sinks)) (StreamingLLM).

    Returns:
      [batch, q_heads, head_dim] output (q.dtype), plus LSE if requested.
    """
    del interpret, d64_unpadded
    k_vals, k_scales = _split_quant(k_cache)
    v_vals, v_scales = _split_quant(v_cache)

    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, max_seq, _ = k_vals.shape

    if attention_sinks and not ring_buffer:
        raise ValueError("attention_sinks requires ring_buffer=True")
    if ring_buffer:
        if sliding_window is None:
            raise ValueError("ring_buffer requires sliding_window")
        if max_seq % 128:
            raise ValueError(
                f"ring_buffer requires a 128-multiple buffer, got {max_seq}"
            )
        ring_cap = max_seq - (
            ceil_to(attention_sinks, 128) if attention_sinks else 0
        )
        if sliding_window > ring_cap:
            raise ValueError(
                f"ring region ({ring_cap} of buffer {max_seq}) must hold "
                f"the whole window ({sliding_window})"
            )
    if block_kv is not None and (block_kv < 128 or block_kv % 128):
        raise ValueError(
            f"block_kv must be a positive multiple of 128, got {block_kv}"
        )
    if (
        auto_split and not save_residuals and not ring_buffer
        and sliding_window is None and logit_softcap is None
    ):
        probe_kv = block_kv or select_decode_block_sizes(max_seq).block_kv
        ns = should_split_decode(batch, num_kv_heads, max_seq, probe_kv)
        if ns:
            return decode_attention_split(
                q, k_cache, v_cache, lengths,
                num_splits=ns, sm_scale=sm_scale, block_kv=block_kv,
            )
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if sliding_window is not None and sliding_window < 1:
        # A window of 0 would leave every slot masked and emit zeros for a
        # token that must at least see itself — reject like the forward.
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)

    group = num_q_heads // num_kv_heads
    compute = q.dtype
    qg = q.reshape(batch, num_kv_heads, group, head_dim)
    with jax.named_scope("decode_attention"):
        s = jnp.einsum(
            "bhgd,bhsd->bhgs", qg, k_vals.astype(compute),
            preferred_element_type=jnp.float32,
        )
        if k_scales is not None:
            s = s * jnp.swapaxes(k_scales, 2, 3).astype(jnp.float32)
        if logit_softcap is not None:
            s = jnp.tanh(s * (sm_scale / logit_softcap)) * (
                logit_softcap * LOG2E
            )
        else:
            s = s * (sm_scale * LOG2E)
        ok = _visible(
            lengths.astype(jnp.int32), max_seq, window=sliding_window,
            ring_buffer=ring_buffer, sinks=attention_sinks,
        )[:, None, None, :]
        s = jnp.where(ok, s, MASK_VALUE)
        m = jnp.maximum(jnp.max(s, axis=-1, keepdims=True), M_FLOOR)
        p = jnp.exp2(s - m)
        l = jnp.sum(p, axis=-1, keepdims=True)
        if v_scales is not None:
            p = p * jnp.swapaxes(v_scales, 2, 3).astype(jnp.float32)
        o = jnp.einsum(
            "bhgs,bhsd->bhgd", p.astype(compute), v_vals.astype(compute),
            preferred_element_type=jnp.float32,
        )
        empty = l == 0.0
        l_safe = jnp.where(empty, 1.0, l)
        out = (o / l_safe).astype(q.dtype).reshape(batch, num_q_heads, head_dim)
    if save_residuals:
        lse2 = jnp.where(empty, -jnp.inf, m + jnp.log2(l_safe))
        return out, lse2.reshape(batch, num_q_heads)
    return out


def decode_attention_split(
    q: jax.Array,
    k_cache,
    v_cache,
    lengths: jax.Array,
    *,
    num_splits: int = 4,
    sm_scale: float | None = None,
    block_kv: int | None = None,
    interpret: bool | None = None,
    d64_unpadded: bool = False,
):
    """Flash-decoding: split the KV range, attend per split, LSE-merge.

    The live version of the reference's split-K grid.z path + merge kernel
    (flash_attention.cu:174-176, 559-598). Splits become extra batch rows
    (more independent work when batch*kv_heads is small); the merge is the
    spec'd primitive from ops/merge.py.
    """
    del interpret, d64_unpadded
    k_vals, k_scales = _split_quant(k_cache)
    v_vals, v_scales = _split_quant(v_cache)
    batch, num_q_heads, head_dim = q.shape
    _, num_kv_heads, max_seq, _ = k_vals.shape
    if max_seq % num_splits:
        raise ValueError(f"max_seq={max_seq} % num_splits={num_splits} != 0")
    split_len = max_seq // num_splits

    def resplit(x):
        # [B, H, S, d] -> [B*ns, H, S/ns, d]
        b, h, s, d = x.shape
        x = x.reshape(b, h, num_splits, s // num_splits, d)
        x = jnp.moveaxis(x, 2, 1)  # [B, ns, H, S/ns, d]
        return x.reshape(b * num_splits, h, s // num_splits, d)

    k_r = resplit(k_vals)
    v_r = resplit(v_vals)
    if k_scales is not None:
        k_r = QuantizedTensor(values=k_r, scales=resplit(k_scales))
        v_r = QuantizedTensor(values=v_r, scales=resplit(v_scales))
    q_r = jnp.broadcast_to(
        q[:, None], (batch, num_splits, num_q_heads, head_dim)
    ).reshape(batch * num_splits, num_q_heads, head_dim)
    split_starts = jnp.tile(jnp.arange(num_splits) * split_len, batch)
    lengths_r = jnp.clip(
        jnp.repeat(lengths, num_splits) - split_starts, 0, split_len
    ).astype(jnp.int32)

    o, lse2 = decode_attention(
        q_r, k_r, v_r, lengths_r, sm_scale=sm_scale, save_residuals=True,
    )
    o = o.reshape(batch, num_splits, num_q_heads, head_dim)
    lse2 = lse2.reshape(batch, num_splits, num_q_heads)
    merged, _ = merge_partial_attention(o, lse2, axis=1)
    return merged
