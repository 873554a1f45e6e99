"""GQA attention layer with a decode KV cache, built on the Pallas kernels.

The layer is the consumer the reference never had: it routes prefill through
ops/flash_attention.py (causal forward) and decode through ops/decode.py
(flash-decoding over the cache), with optional int8/fp8 cache quantization
(ops/quant.py). Functional style: params and cache are pytrees; everything
jits and shards (heads over the mesh "model" axis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from flash_attention_tpu.ops.common import LOG2E, ceil_to as _ceil_to
from flash_attention_tpu.ops.decode import decode_attention
from flash_attention_tpu.ops.merge import merge_two
from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.quant import QuantizedTensor, quantize_fp8, quantize_int8
from flash_attention_tpu.models.rope import apply_rope


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    model_dim: int
    num_q_heads: int
    num_kv_heads: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    kv_quant: str = "none"  # none | int8 | fp8_e4m3 | fp8_e5m2
    dtype: str = "bfloat16"
    sliding_window: int | None = None  # Mistral-style local attention
    logit_softcap: float | None = None  # Gemma-style attn logit cap
    # Rolling (ring-buffer) KV cache: with sliding_window set, allocate only
    # ~window rows per slot and store position p at slot p % buffer —
    # O(window) cache memory however long the context runs (Mistral's
    # rolling cache). `lengths` then counts TOTAL positions written.
    rolling: bool = False
    # StreamingLLM attention sinks (requires rolling): keep the first
    # `attention_sinks` positions permanently resident and attended next to
    # the sliding window — unbounded streaming generation without the
    # quality collapse of evicting the sink tokens. Decode masks
    # sinks ∪ (len-window, len]; chunked prefill merges a sink pass with
    # the window-band pass through the C5 LSE merge (ops/merge.py).
    attention_sinks: int = 0

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


class KVCache(NamedTuple):
    """Decode cache: [B, Hkv, max_seq, D] payload (+ scales when quantized)."""

    k: jax.Array
    v: jax.Array
    k_scales: jax.Array | None
    v_scales: jax.Array | None
    lengths: jax.Array  # [B] int32 — valid prefix per sequence

    def quantized(self) -> bool:
        return self.k_scales is not None

    def k_view(self):
        return QuantizedTensor(self.k, self.k_scales) if self.quantized() else self.k

    def v_view(self):
        return QuantizedTensor(self.v, self.v_scales) if self.quantized() else self.v


def init_attention_params(key, cfg: AttentionConfig):
    dt = cfg.jnp_dtype
    kq, kk, kv, ko = jax.random.split(key, 4)
    s = 1.0 / math.sqrt(cfg.model_dim)
    so = 1.0 / math.sqrt(cfg.num_q_heads * cfg.head_dim)
    return {
        "wq": (jax.random.normal(kq, (cfg.model_dim, cfg.num_q_heads, cfg.head_dim), jnp.float32) * s).astype(dt),
        "wk": (jax.random.normal(kk, (cfg.model_dim, cfg.num_kv_heads, cfg.head_dim), jnp.float32) * s).astype(dt),
        "wv": (jax.random.normal(kv, (cfg.model_dim, cfg.num_kv_heads, cfg.head_dim), jnp.float32) * s).astype(dt),
        "wo": (jax.random.normal(ko, (cfg.num_q_heads, cfg.head_dim, cfg.model_dim), jnp.float32) * so).astype(dt),
    }


def rolling_buffer_len(cfg: AttentionConfig, max_seq: int, prefill_chunk: int = 0) -> int:
    """Ring-buffer rows per slot: the window plus one prefill chunk of
    slack (a chunk of T rows overwrites slots T behind the write head, so
    the buffer must hold window + T rows for the chunk's own lookback),
    128-aligned, capped at the logical context. Attention sinks add their
    own 128-padded region in front of the ring."""
    need = cfg.sliding_window + max(prefill_chunk, 1)
    ring = -(-need // 128) * 128
    if cfg.attention_sinks:
        ring += -(-cfg.attention_sinks // 128) * 128
    return min(max_seq, ring)


def init_kv_cache(
    cfg: AttentionConfig, batch: int, max_seq: int, *, prefill_chunk: int = 0
) -> KVCache:
    from flash_attention_tpu.ops.quant import payload_dtype

    if cfg.rolling and cfg.sliding_window is None:
        raise ValueError("rolling cache requires sliding_window")
    if cfg.attention_sinks:
        if not cfg.rolling:
            raise ValueError("attention_sinks requires rolling=True")
        if cfg.attention_sinks + max(prefill_chunk, 1) > cfg.sliding_window:
            # The chunked-prefill sink merge needs every chunk past the
            # window to start at or after the sink region.
            raise ValueError(
                f"attention_sinks ({cfg.attention_sinks}) + prefill chunk "
                f"({prefill_chunk}) must not exceed sliding_window "
                f"({cfg.sliding_window})"
            )
    buf = (
        rolling_buffer_len(cfg, max_seq, prefill_chunk)
        if cfg.rolling else max_seq
    )
    payload = payload_dtype(cfg.kv_quant) or cfg.jnp_dtype
    quant = cfg.kv_quant != "none"
    shape = (batch, cfg.num_kv_heads, buf, cfg.head_dim)
    max_seq = buf
    return KVCache(
        k=jnp.zeros(shape, payload),
        v=jnp.zeros(shape, payload),
        k_scales=jnp.ones((batch, cfg.num_kv_heads, max_seq, 1), jnp.float32) if quant else None,
        v_scales=jnp.ones((batch, cfg.num_kv_heads, max_seq, 1), jnp.float32) if quant else None,
        lengths=jnp.zeros((batch,), jnp.int32),
    )


def _quantize_for_cache(cfg: AttentionConfig, x: jax.Array):
    from flash_attention_tpu.ops.quant import payload_dtype, quantize_values

    payload = payload_dtype(cfg.kv_quant)
    if payload is None:
        return x.astype(cfg.jnp_dtype), None
    qt = quantize_values(x, payload)
    return qt.values, qt.scales


def write_cache(cfg: AttentionConfig, cache: KVCache, k_new, v_new, start_positions) -> KVCache:
    """Insert [B, Hkv, T, D] new K/V rows at per-sequence start positions.

    Decode writes (T == 1) at or past capacity are DROPPED and the length
    freezes at max_seq — dynamic_update_slice would instead clamp the
    position and silently overwrite the last live row's K/V. Prefill writes
    (T > 1) must satisfy start + T <= max_seq (the engines clamp their
    chunk grids to guarantee it); lengths clamp to max_seq either way.
    """
    kq, ks = _quantize_for_cache(cfg, k_new)
    vq, vs = _quantize_for_cache(cfg, v_new)
    t = k_new.shape[2]
    max_seq = cache.k.shape[2]
    # Batch, head and row are all indexed so the scatters update the donated
    # buffers in place (a slice between indexed dimensions makes XLA
    # transpose the whole buffer there and back).
    batch_idx = jnp.arange(k_new.shape[0])[:, None, None]
    head_idx = jnp.arange(k_new.shape[1])[None, :, None]

    if cfg.rolling and cfg.attention_sinks:
        # StreamingLLM two-region layout: positions [0, sinks) at their own
        # slots, the rest in a ring over the remaining buffer. Rows a long
        # write would itself evict (neither sink nor within the last
        # ring-modulus rows) map out of bounds and drop.
        sinks = cfg.attention_sinks
        spad = _ceil_to(sinks, 128)
        mod = max_seq - spad
        p = start_positions[:, None] + jnp.arange(t)[None]  # [B, t]
        slot_idx = jnp.where(p < sinks, p, spad + (p - sinks) % mod)
        keep = jnp.logical_or(
            p < sinks, p >= (start_positions[:, None] + t) - mod
        )
        pos = jnp.where(keep, slot_idx, max_seq)  # OOB -> dropped

        def upd(buf, new):
            return buf.at[batch_idx, head_idx, pos[:, None, :]].set(
                new.astype(buf.dtype), mode="drop"
            )

        new_lengths = start_positions + t
    elif cfg.rolling:
        # Ring buffer: position p lives at slot p % buffer; lengths count
        # TOTAL positions (no capacity clamp — old rows roll out of the
        # window instead of new writes dropping). A write longer than the
        # buffer keeps only its LAST buffer-many rows (earlier ones would
        # alias the same slots).
        keep = min(t, max_seq)
        if keep != t:
            kq, vq = kq[:, :, t - keep :], vq[:, :, t - keep :]
            if ks is not None:
                ks, vs = ks[:, :, t - keep :], vs[:, :, t - keep :]
        pos = (
            start_positions[:, None] + (t - keep) + jnp.arange(keep)[None]
        ) % max_seq  # [B, keep]

        def upd(buf, new):
            # new: [B, H, keep, *] -> scatter rows at per-batch slots.
            return buf.at[batch_idx, head_idx, pos[:, None, :]].set(
                new.astype(buf.dtype)
            )

        new_lengths = start_positions + t
    elif t == 1:

        def upd(buf, new):
            # start == max_seq is out of bounds -> dropped (not clamped).
            return buf.at[
                batch_idx, head_idx, start_positions[:, None, None]
            ].set(new.astype(buf.dtype), mode="drop")

        new_lengths = jnp.minimum(start_positions + t, max_seq)
    else:

        def upd(buf, new):
            def one(buf_b, new_b, pos):
                return jax.lax.dynamic_update_slice(buf_b, new_b.astype(buf_b.dtype), (0, pos, 0))
            return jax.vmap(one)(buf, new, start_positions)

        new_lengths = jnp.minimum(start_positions + t, max_seq)

    cache = cache._replace(
        k=upd(cache.k, kq),
        v=upd(cache.v, vq),
        lengths=new_lengths,
    )
    if cache.k_scales is not None:
        cache = cache._replace(
            k_scales=upd(cache.k_scales, ks),
            v_scales=upd(cache.v_scales, vs),
        )
    return cache


def _project_qkv(params, cfg: AttentionConfig, x: jax.Array, positions):
    """Shared q/k/v projection + RoPE for every attention_* entry point.

    x: [B, T, model_dim]; positions: int32 broadcastable to [B, 1, T].
    Returns (q, k, v) as [B, H, T, D] in the config dtype, q/k rotated.
    """
    from flash_attention_tpu.ops.quant import w8_dequant

    q = jnp.einsum(
        "btm,mhd->bhtd", x, w8_dequant(params["wq"])
    ).astype(cfg.jnp_dtype)
    k = jnp.einsum(
        "btm,mhd->bhtd", x, w8_dequant(params["wk"])
    ).astype(cfg.jnp_dtype)
    v = jnp.einsum(
        "btm,mhd->bhtd", x, w8_dequant(params["wv"])
    ).astype(cfg.jnp_dtype)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _wo(params):
    from flash_attention_tpu.ops.quant import w8_dequant

    return w8_dequant(params["wo"])


def _output_proj(params, o: jax.Array, out_dtype):
    """wo projection of [B, H, T, D] kernel output -> [B, T, model_dim].

    Low-precision operands with fp32 accumulation (the transformer.py
    einsum convention) — upcasting wo to fp32 would materialize a weight
    copy per call and leave the bf16 tensor-core path.
    """
    out = jnp.einsum(
        "bhtd,hdm->btm", o, _wo(params), preferred_element_type=jnp.float32
    )
    return out.astype(out_dtype)


def _output_proj_decode(params, o: jax.Array, out_dtype):
    """wo projection of single-token [B, H, D] output -> [B, 1, model_dim]."""
    out = jnp.einsum(
        "bhd,hdm->bm", o, _wo(params), preferred_element_type=jnp.float32
    )
    return out[:, None, :].astype(out_dtype)


def attention_prefill(
    params, cfg: AttentionConfig, x: jax.Array, cache: KVCache, *, block_sizes=None
):
    """Causal prefill over [B, T, model_dim]; fills the cache from position 0.

    Returns (output [B, T, model_dim], updated cache).
    """
    batch, t, _ = x.shape
    if cfg.attention_sinks and t > cfg.sliding_window:
        raise ValueError(
            "attention_sinks prompts longer than the window must prefill in "
            "chunks (attention_prefill_chunk applies the sinks ∪ window "
            "mask; the one-shot path would mask the sinks out)"
        )
    q, k, v = _project_qkv(params, cfg, x, jnp.arange(t)[None, None, :])

    o = flash_attention(
        q, k, v, causal=True, block_sizes=block_sizes,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
    )
    out = _output_proj(params, o, x.dtype)
    cache = write_cache(cfg, cache, k, v, jnp.zeros((batch,), jnp.int32))
    return out, cache


def attention_forward(
    params, cfg: AttentionConfig, x: jax.Array, *, positions=None,
    segment_ids=None, block_sizes=None,
):
    """Training-mode causal self-attention over [B, T, model_dim] (no cache).

    Args:
      positions: optional [B, T] int32 RoPE positions (packed sequences
        restart positions per document); defaults to arange(T).
      segment_ids: optional [B, T] int32 packed-sequence ids, masked in the
        fused kernel.

    Returns [B, T, model_dim]; differentiable end to end.
    """
    _, t, _ = x.shape
    if positions is None:
        pos = jnp.arange(t)[None, None, :]
    else:
        pos = positions[:, None, :]
    q, k, v = _project_qkv(params, cfg, x, pos)
    o = flash_attention(
        q, k, v, causal=True, block_sizes=block_sizes,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
        segment_ids=segment_ids,
    )
    return _output_proj(params, o, x.dtype)


def attention_prefill_chunk(
    params, cfg: AttentionConfig, x: jax.Array, cache: KVCache, slot, start,
    kv_end: int, *, block_sizes=None,
):
    """Prefill ONE CHUNK of one sequence into its slot of a batched cache.

    Chunked prefill (the scheduler-level analog of the reference's streaming
    KV hot loop, flash_attention.cu:417-453): the chunk's queries attend the
    slot's whole cache prefix plus the chunk itself, using the kernel's
    kv_len > q_len diagonal offset. The caller schedules chunks so
    ``start + T == kv_end`` with kv_end STATIC (chunk boundaries at fixed
    multiples), which keeps the visible-KV slice shape static per chunk index.

    Args:
      x: [1, T, model_dim] — the chunk (right-padded on the LAST chunk only;
        padded rows write garbage K/V past the true length, which no later
        chunk or decode step can see).
      cache: the batched [slots, ...] KVCache (updated in place functionally).
      slot: scalar int32 — which batch row.
      start: scalar int32 — the chunk's first token position (start+T==kv_end).
      kv_end: static int — visible KV horizon for this chunk.

    Returns:
      (output [1, T, model_dim], updated cache).
    """
    _, t, _ = x.shape
    q, k, v = _project_qkv(
        params, cfg, x, start + jnp.arange(t)[None, None, :]
    )

    # Write the chunk's K/V into the slot's rows FIRST so the visible slice
    # [0, kv_end) includes the chunk itself.
    kq, ks = _quantize_for_cache(cfg, k)
    vq, vs = _quantize_for_cache(cfg, v)
    slot = jnp.asarray(slot, jnp.int32)
    start = jnp.asarray(start, jnp.int32)
    new_len = (start + t).astype(cache.lengths.dtype)
    w_buf = cache.k.shape[2]
    sinks = cfg.attention_sinks
    spad = _ceil_to(sinks, 128) if sinks else 0
    ring_mod = w_buf - spad
    if cfg.rolling:
        # Ring write: the chunk's rows land at their positions mod the ring
        # (a chunk may wrap the boundary, so scatter, not a slice); with
        # attention sinks, positions below `sinks` keep their own slots.
        if ring_mod < cfg.sliding_window + t:
            raise ValueError(
                f"rolling ring ({ring_mod} of buffer {w_buf}) must hold "
                f"window ({cfg.sliding_window}) + chunk ({t}) rows — init "
                "the cache with prefill_chunk set"
            )
        p_abs = start + jnp.arange(t)  # [t]
        if sinks:
            pos = jnp.where(
                p_abs < sinks, p_abs, spad + (p_abs - sinks) % ring_mod
            )
        else:
            pos = p_abs % w_buf

        def ring_upd(buf, new):
            # new: [1, H, t, *] -> rows scattered at the slot's ring slots
            # (slot, head and row indexed: an in-place scatter).
            heads = jnp.arange(buf.shape[1])[:, None]
            return buf.at[slot, heads, pos[None, :]].set(
                new[0].astype(buf.dtype)
            )

        cache = cache._replace(
            k=ring_upd(cache.k, kq),
            v=ring_upd(cache.v, vq),
            lengths=jax.lax.dynamic_update_slice(
                cache.lengths, new_len[None], (slot,)
            ),
        )
        if cache.k_scales is not None:
            cache = cache._replace(
                k_scales=ring_upd(cache.k_scales, ks),
                v_scales=ring_upd(cache.v_scales, vs),
            )
    else:
        cache = cache._replace(
            k=jax.lax.dynamic_update_slice(
                cache.k, kq.astype(cache.k.dtype), (slot, 0, start, 0)
            ),
            v=jax.lax.dynamic_update_slice(
                cache.v, vq.astype(cache.v.dtype), (slot, 0, start, 0)
            ),
            lengths=jax.lax.dynamic_update_slice(
                cache.lengths, new_len[None], (slot,)
            ),
        )
        if cache.k_scales is not None:
            cache = cache._replace(
                k_scales=jax.lax.dynamic_update_slice(
                    cache.k_scales, ks, (slot, 0, start, 0)
                ),
                v_scales=jax.lax.dynamic_update_slice(
                    cache.v_scales, vs, (slot, 0, start, 0)
                ),
            )

    hkv, d = cache.k.shape[1], cache.k.shape[3]

    def gather_positions(gpos):
        """Gather ring rows at slot indices `gpos` in position order."""

        def one(buf, scales):
            vis = buf[slot, :, gpos, :]  # [g, hkv, d] (adv-index axis first)
            vis = jnp.swapaxes(vis, 0, 1)[None]  # [1, hkv, g, d]
            if scales is None:
                return vis
            sc = jnp.swapaxes(scales[slot, :, gpos, :], 0, 1)[None]
            return (vis.astype(jnp.float32) * sc).astype(cfg.jnp_dtype)

        return (
            one(cache.k, cache.k_scales), one(cache.v, cache.v_scales)
        )

    def slot_of(p_abs):
        if sinks:
            return jnp.where(
                p_abs < sinks, p_abs, spad + (p_abs - sinks) % ring_mod
            )
        return p_abs % w_buf

    if cfg.rolling and sinks and kv_end > cfg.sliding_window:
        # StreamingLLM chunk attention past the window: every chunk row
        # attends sinks ∪ its window band. Run the band pass (causal +
        # window, end-aligned) and the sink pass (full visibility — the
        # init-time sinks+chunk <= window check guarantees the chunk starts
        # past the sink region) and combine through the C5 LSE merge.
        g = min(cfg.sliding_window + t, kv_end - sinks)
        k_band, v_band = gather_positions(
            slot_of((kv_end - g) + jnp.arange(g))
        )
        o_band, lse_band = flash_attention(
            q, k_band, v_band, causal=True, block_sizes=block_sizes,
            sliding_window=cfg.sliding_window,
            logit_softcap=cfg.logit_softcap, save_residuals=True,
        )
        k_sink, v_sink = gather_positions(jnp.arange(sinks))
        o_sink, lse_sink = flash_attention(
            q, k_sink, v_sink, causal=False,
            logit_softcap=cfg.logit_softcap, save_residuals=True,
        )
        o, _ = merge_two(o_band, lse_band, o_sink, lse_sink)
        o = o.astype(q.dtype)
        return _output_proj(params, o, x.dtype), cache
    elif cfg.rolling:
        # Visible window for the chunk: only the last min(kv_end, window+T)
        # positions matter (the chunk's first row looks back `window`; with
        # sinks, kv_end <= window here so nothing is evicted yet and the
        # plain causal+window mask is exact). Gather them in POSITION ORDER
        # from the ring slots so the kernel sees an ordered, end-aligned
        # KV slice.
        g = min(kv_end, cfg.sliding_window + t)
        k_vis, v_vis = gather_positions(
            slot_of((kv_end - g) + jnp.arange(g))
        )
    else:

        def visible(buf, scales):
            vis = jax.lax.dynamic_slice(
                buf, (slot, 0, 0, 0), (1, hkv, kv_end, d)
            )
            if scales is None:
                return vis
            # Quantized cache: dequantize the visible slice in-graph (one
            # XLA pass; chunk attention is compute-bound so the widen is
            # cheap relative to the TxS matmuls it feeds).
            sc = jax.lax.dynamic_slice(
                scales, (slot, 0, 0, 0), (1, hkv, kv_end, 1)
            )
            return (vis.astype(jnp.float32) * sc).astype(cfg.jnp_dtype)

        k_vis = visible(cache.k, cache.k_scales)
        v_vis = visible(cache.v, cache.v_scales)

    o = flash_attention(
        q, k_vis, v_vis, causal=True, block_sizes=block_sizes,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
    )
    return _output_proj(params, o, x.dtype), cache


def attention_prefill_paged(
    params, cfg: AttentionConfig, x: jax.Array, paged_cache, slot, true_len,
    *, block_sizes=None
):
    """Causal prefill of ONE sequence ([1, T, model_dim], T a multiple of the
    page size) writing its K/V into ``slot``'s pages of a PagedKVCache.

    Returns (output [1, T, model_dim], updated cache).
    """
    from flash_attention_tpu.ops.paged import paged_write_prefill

    _, t, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, jnp.arange(t)[None, None, :])

    o = flash_attention(
        q, k, v, causal=True, block_sizes=block_sizes,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
    )
    out = _output_proj(params, o, x.dtype)
    paged_cache = paged_write_prefill(paged_cache, k[0], v[0], slot, true_len)
    return out, paged_cache


def attention_prefill_chunk_paged(
    params, cfg: AttentionConfig, x: jax.Array, paged_cache, slot, start,
    kv_end: int, *, block_sizes=None,
):
    """Chunked prefill over a PAGED cache: one chunk ([1, T, model_dim], T a
    page multiple) of one sequence, attending the slot's pages [0, kv_end)
    (start + T == kv_end, kv_end static). Returns (output, updated cache)."""
    from flash_attention_tpu.ops.paged import (
        paged_prefill_attention,
        paged_write_prefill,
    )

    _, t, _ = x.shape
    q, k, v = _project_qkv(
        params, cfg, x, start + jnp.arange(t)[None, None, :]
    )

    paged_cache = paged_write_prefill(
        paged_cache, k[0], v[0], slot, jnp.asarray(start) + t, start=start
    )
    # The chunk attends the band of pages its rows can see: all of
    # [0, kv_end), or with a sliding window only the window band plus the
    # pinned sink page — which also keeps it off the paged ring's rolled-out
    # logical pages, whose physical pages now hold newer positions.
    o = paged_prefill_attention(
        q, paged_cache, slot, kv_end, chunk_len=t,
        logit_softcap=cfg.logit_softcap,
        sliding_window=cfg.sliding_window,
        attention_sinks=cfg.attention_sinks,
    )
    return _output_proj(params, o, x.dtype), paged_cache


def attention_decode_paged_deferred(
    params, cfg: AttentionConfig, x: jax.Array, paged_cache
):
    """Decode-step attention WITHOUT the per-layer cache write.

    A per-layer scatter write is one more small dispatch per layer. Here
    the kernel attends
    over the cache as-is (the new token is NOT in it) and the current
    token's self-attention term — score q.k_new at full precision, output
    v_new — is folded in with the standard LSE combine (ops/merge.py). The
    caller batches every layer's (k_new, v_new) into ONE
    paged_write_tokens_multi call after the layer stack.

    Returns (output [num_slots, 1, model_dim], (k_new, v_new) each
    [num_slots, kv_heads, head_dim]).
    """
    from flash_attention_tpu.ops.merge import merge_two
    from flash_attention_tpu.ops.paged import paged_decode_attention

    q, k, v = _project_qkv(
        params, cfg, x, paged_cache.lengths[:, None, None]
    )
    q1 = q[:, :, 0, :]  # [n, Hq, D]
    k1 = k[:, :, 0, :]  # [n, Hkv, D]
    v1 = v[:, :, 0, :]
    # Window off-by-one: the kernel's band is `col >= lengths - window` and
    # here lengths does NOT yet include the current token (the write is
    # deferred), so the same window value would admit one extra cache
    # token. window-1 restores the exact band; the self term supplies the
    # current token. (sliding_window == 1 would need window 0, which the
    # kernel rejects — decode_step_logits_paged falls back to the
    # write-first path for that degenerate config.)
    win = cfg.sliding_window
    if win is not None:
        if win <= 1:
            raise ValueError(
                "deferred decode requires sliding_window > 1; use "
                "attention_decode_paged"
            )
        win = win - 1
    o_c, lse_c = paged_decode_attention(
        q1, paged_cache, save_residuals=True,
        sliding_window=win, logit_softcap=cfg.logit_softcap,
        attention_sinks=cfg.attention_sinks,
    )
    # Self term: the current token always attends to itself (in-window by
    # definition). Raw score per q head against its group's kv head, run
    # through the kernel's exact logit pipeline (softcap then scale), in
    # the base-2 LSE domain of the merge contract.
    group = cfg.num_q_heads // cfg.num_kv_heads
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)
    k_exp = jnp.repeat(k1, group, axis=1)  # [n, Hq, D]
    v_exp = jnp.repeat(v1, group, axis=1)
    s_raw = jnp.sum(
        q1.astype(jnp.float32) * k_exp.astype(jnp.float32), axis=-1
    )  # [n, Hq]
    if cfg.logit_softcap is not None:
        cap = cfg.logit_softcap
        logits = jnp.tanh(s_raw * sm_scale / cap) * cap
    else:
        logits = s_raw * sm_scale
    lse_self = logits * LOG2E  # single-score LSE == the score itself
    o, _ = merge_two(o_c, lse_c, v_exp, lse_self)
    return _output_proj_decode(params, o, x.dtype), (k1, v1)


def attention_decode_paged(params, cfg: AttentionConfig, x: jax.Array, paged_cache):
    """One decode step over [num_slots, 1, model_dim] against a paged cache.

    Writes every slot's new K/V token at its current length (the engine
    freezes lengths for inactive slots afterwards; their writes land in pages
    they still own, or the dump page once released) and runs paged decode
    attention. Returns (output [num_slots, 1, model_dim], updated cache).
    """
    from flash_attention_tpu.ops.paged import (
        paged_decode_attention,
        paged_write_tokens,
    )

    num_slots = x.shape[0]
    q, k, v = _project_qkv(
        params, cfg, x, paged_cache.lengths[:, None, None]
    )

    paged_cache = paged_write_tokens(
        paged_cache, k[:, :, 0, :], v[:, :, 0, :], jnp.arange(num_slots)
    )
    o = paged_decode_attention(
        q[:, :, 0, :], paged_cache,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
        attention_sinks=cfg.attention_sinks,
    )
    return _output_proj_decode(params, o, x.dtype), paged_cache


def attention_decode(
    params, cfg: AttentionConfig, x: jax.Array, cache: KVCache, *, block_kv: int | None = None
):
    """One decode step over [B, 1, model_dim] against the cache.

    Returns (output [B, 1, model_dim], updated cache).
    """
    # positions = next position per sequence
    q, k, v = _project_qkv(params, cfg, x, cache.lengths[:, None, None])

    cache = write_cache(cfg, cache, k, v, cache.lengths)
    o = decode_attention(
        q[:, :, 0, :], cache.k_view(), cache.v_view(), cache.lengths,
        block_kv=block_kv,
        sliding_window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
        ring_buffer=cfg.rolling, attention_sinks=cfg.attention_sinks,
    )
    return _output_proj_decode(params, o, x.dtype), cache
