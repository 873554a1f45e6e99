"""Paged KV-cache attention (block-table decode and chunked prefill).

Serving engines fragment KV memory unless the cache is paged: fixed-size
pages owned by a free-list allocator (native/src/scheduler.cpp's page
allocator), with each sequence holding a page table instead of a contiguous
region. This module is the device side:

  * decode runs a Triton-route Pallas kernel in which every program loads
    its own page-table entries and streams its slot's pages in place,
    dequantizing int8 / fp8 payloads in registers (a plain version would
    first gather every slot's pages into a dense copy, each layer and step);
    the KV range is split across programs and the splits LSE-merged, the
    reference's latent split-K (flash_attention.cu:169-180, 559-598);
  * chunked prefill gathers the chunk's visible page band into a dense view
    and runs the forward kernel over it — a 1024-row chunk does far more
    work per KV byte than the gather costs;
  * cache writes are XLA scatters into the (donated) page pools.

Numerics are the shared contract (ops/common.py): fp32 accumulators,
exp2-domain online softmax, base-2 LSE residuals compatible with ops/merge.py.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from flash_attention_tpu.ops.common import (
    LOG2E,
    M_FLOOR,
    MASK_VALUE,
    next_pow2,
    resolve_interpret,
    triton_params,
)
from flash_attention_tpu.ops.merge import merge_partial_attention, merge_two


class PagedKVCache(NamedTuple):
    """Paged KV storage.

    k_pages, v_pages: [num_pages, kv_heads, page_size, head_dim] — bf16/fp16
      or quantized int8/fp8 payloads.
    k_scales, v_scales: None, or [num_pages, kv_heads, 1, page_size] fp32
      per-token dequant scales.
    page_table: [num_slots, pages_per_slot] int32 — physical page id per
      logical page; entries past the sequence's last page are unused (any
      value; the kernels never read them).
    lengths: [num_slots] int32 — valid tokens per slot.
    """

    k_pages: jax.Array
    v_pages: jax.Array
    page_table: jax.Array
    lengths: jax.Array
    k_scales: jax.Array | None = None
    v_scales: jax.Array | None = None

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def pages_per_slot(self) -> int:
        return self.page_table.shape[1]

    def quantized(self) -> bool:
        return self.k_scales is not None


def init_paged_cache(
    *,
    num_pages: int,
    num_slots: int,
    pages_per_slot: int,
    kv_heads: int,
    page_size: int = 512,
    head_dim: int = 128,
    dtype=jnp.bfloat16,
    kv_quant: str = "none",
) -> PagedKVCache:
    from flash_attention_tpu.ops.quant import payload_dtype

    payload = payload_dtype(kv_quant) or dtype
    shape = (num_pages, kv_heads, page_size, head_dim)
    quant = kv_quant != "none"
    sshape = (num_pages, kv_heads, 1, page_size)
    return PagedKVCache(
        k_pages=jnp.zeros(shape, payload),
        v_pages=jnp.zeros(shape, payload),
        page_table=jnp.zeros((num_slots, pages_per_slot), jnp.int32),
        lengths=jnp.zeros((num_slots,), jnp.int32),
        k_scales=jnp.ones(sshape, jnp.float32) if quant else None,
        v_scales=jnp.ones(sshape, jnp.float32) if quant else None,
    )


def _quantize_rows(x, payload_dtype):
    """Per-token (last-axis) symmetric quantization -> (payload, scales)."""
    from flash_attention_tpu.ops.quant import quantize_values

    qt = quantize_values(x, payload_dtype)
    return qt.values, qt.scales


def _token_targets(cache: PagedKVCache, slots):
    """(physical page, row offset, in-range) of each slot's next token."""
    page_size = cache.page_size
    pos = cache.lengths[slots]
    # A slot at capacity must not write AT ALL: clamping the page index
    # alone would wrap the offset to 0 and overwrite the LIVE row at
    # position (pages_per_slot-1)*page_size.
    in_range = pos < cache.pages_per_slot * page_size
    logical = jnp.minimum(pos // page_size, cache.pages_per_slot - 1)
    phys = cache.page_table[slots, logical].astype(jnp.int32)
    return phys, (pos % page_size).astype(jnp.int32), in_range


def _write_token_rows(cache: PagedKVCache, k_new, v_new, phys, offset, valid):
    """Scatter one [kv_heads, head_dim] row per entry; invalid entries are
    routed out of bounds and dropped.

    Page, head and row are all indexed (broadcast to [n, kv_heads]), so the
    scatter updates the donated pool in place. A slice between the indexed
    page and row dimensions would make XLA transpose the whole pool there
    and back around the scatter."""
    num_pages, kv_heads = cache.k_pages.shape[:2]
    page = jnp.where(valid, phys, num_pages)[:, None]
    row = offset[:, None]
    head = jnp.arange(kv_heads)[None, :]
    if cache.quantized():
        kq, ks = jax.vmap(lambda x: _quantize_rows(x, cache.k_pages.dtype))(k_new)
        vq, vs = jax.vmap(lambda x: _quantize_rows(x, cache.v_pages.dtype))(v_new)
        cache = cache._replace(
            k_scales=cache.k_scales.at[page, head, 0, row].set(
                ks[:, :, 0].astype(jnp.float32), mode="drop"
            ),
            v_scales=cache.v_scales.at[page, head, 0, row].set(
                vs[:, :, 0].astype(jnp.float32), mode="drop"
            ),
        )
    else:
        kq = k_new.astype(cache.k_pages.dtype)
        vq = v_new.astype(cache.v_pages.dtype)
    return cache._replace(
        k_pages=cache.k_pages.at[page, head, row].set(kq, mode="drop"),
        v_pages=cache.v_pages.at[page, head, row].set(vq, mode="drop"),
    )


def paged_write_tokens_multi(
    caches: list,
    k_news: list,
    v_news: list,
    slots: jax.Array,
    *,
    interpret: bool | None = None,
) -> list:
    """Append ONE token of K/V per slot to EVERY layer's cache.

    Used by the deferred-write decode step (models/transformer.py), which
    batches all layers' writes after the layer stack instead of writing
    inside each layer. caches: L PagedKVCache (same num_slots/page_size/
    quantization; page tables and lengths may differ per layer). k_news/
    v_news: L arrays of [n, kv_heads, head_dim]. Returns the L updated
    caches. Lengths advance in lockstep: a slot at capacity in any layer
    freezes in every layer.
    """
    del interpret
    if not caches:
        return []
    targets = [_token_targets(c, slots) for c in caches]
    valid = targets[0][2]
    for _, _, ok in targets[1:]:
        valid = jnp.logical_and(valid, ok)
    out = []
    for cache, k_new, v_new, (phys, offset, _) in zip(
        caches, k_news, v_news, targets
    ):
        cache = _write_token_rows(cache, k_new, v_new, phys, offset, valid)
        out.append(cache._replace(
            lengths=cache.lengths.at[slots].add(valid.astype(cache.lengths.dtype))
        ))
    return out


def paged_write_tokens(
    cache: PagedKVCache,
    k_new: jax.Array,
    v_new: jax.Array,
    slots: jax.Array,
    *,
    interpret: bool | None = None,
) -> PagedKVCache:
    """Append ONE token of K/V per listed slot at its current length.

    k_new, v_new: [n, kv_heads, head_dim]; slots: [n] int32, each slot listed
    at most once per call (one token per slot per decode step). Returns the
    updated cache (lengths advanced by 1 for the listed slots that were not
    at capacity).
    """
    return paged_write_tokens_multi(
        [cache], [k_new], [v_new], slots, interpret=interpret
    )[0]


def paged_write_prefill(
    cache: PagedKVCache,
    k_new: jax.Array,
    v_new: jax.Array,
    slot,
    true_len,
    start=0,
) -> PagedKVCache:
    """Write a [kv_heads, T, head_dim] prefill K/V into ``slot``'s pages.

    T must be a multiple of the page size (pad the prefill; extra rows land in
    allocated pages and are masked by ``lengths``). ``true_len`` sets the
    slot's valid length. ``start`` (a page multiple, default 0) writes the
    rows at logical positions [start, start+T) — chunked prefill writes each
    chunk at its offset.
    """
    page_size = cache.page_size
    quant = cache.quantized()
    h, t, d = k_new.shape
    if t % page_size:
        raise ValueError(f"prefill length {t} not a multiple of page_size {page_size}")
    n_pages = t // page_size
    start_page = jnp.asarray(start, jnp.int32) // page_size
    phys = lax.dynamic_slice_in_dim(
        cache.page_table[slot], start_page, n_pages
    )  # [n]

    def pages_of(x):  # [H, T, D] -> [n, H, page, D]
        return jnp.swapaxes(x.reshape(h, n_pages, page_size, d), 0, 1)

    k_p, v_p = pages_of(k_new), pages_of(v_new)
    if quant:
        k_p, k_s = _quantize_rows(k_p, cache.k_pages.dtype)  # scales [..., 1]
        v_p, v_s = _quantize_rows(v_p, cache.v_pages.dtype)
        cache = cache._replace(
            k_scales=cache.k_scales.at[phys].set(
                jnp.swapaxes(k_s, 2, 3).astype(jnp.float32)
            ),
            v_scales=cache.v_scales.at[phys].set(
                jnp.swapaxes(v_s, 2, 3).astype(jnp.float32)
            ),
        )
    return cache._replace(
        k_pages=cache.k_pages.at[phys].set(k_p.astype(cache.k_pages.dtype)),
        v_pages=cache.v_pages.at[phys].set(v_p.astype(cache.v_pages.dtype)),
        lengths=cache.lengths.at[slot].set(jnp.asarray(true_len, jnp.int32)),
    )


def _densify(cache: PagedKVCache, phys, dtype):
    """Pages ``phys`` ([n] int32) of K and V as dense [1, H, n*page, D]."""
    n = phys.shape[0]

    def one(pages, scales):
        x = jnp.take(pages, phys, axis=0)  # [n, H, page, D]
        if scales is not None:
            sc = jnp.take(scales, phys, axis=0)  # [n, H, 1, page]
            x = x.astype(jnp.float32) * jnp.swapaxes(sc, 2, 3)
        h, d = x.shape[1], x.shape[3]
        x = jnp.swapaxes(x, 0, 1).reshape(1, h, n * cache.page_size, d)
        return x.astype(dtype)

    return one(cache.k_pages, cache.k_scales), one(cache.v_pages, cache.v_scales)


def paged_gather_kv(cache: PagedKVCache, slot, kv_end: int, dtype=None):
    """Gather ``slot``'s first ``kv_end`` rows (a static page multiple) into
    dense [1, kv_heads, kv_end, head_dim] K and V, dequantized."""
    page_size = cache.page_size
    if kv_end % page_size:
        raise ValueError(f"kv_end={kv_end} not a multiple of page_size {page_size}")
    if dtype is None:
        dtype = jnp.bfloat16 if cache.quantized() else cache.k_pages.dtype
    return _densify(cache, cache.page_table[slot, : kv_end // page_size], dtype)


@functools.partial(
    jax.jit,
    static_argnames=(
        "kv_end", "chunk_len", "sm_scale", "interpret", "logit_softcap",
        "sliding_window", "attention_sinks",
    ),
)
def _paged_prefill_attention_jit(
    q, cache, slot, *, kv_end, chunk_len, sm_scale, interpret, logit_softcap,
    sliding_window, attention_sinks,
):
    from flash_attention_tpu.ops.flash_attention import flash_attention

    page_size = cache.page_size
    head_dim = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    chunk_start = kv_end - chunk_len
    first_page = 0
    if sliding_window is not None:
        # Pages wholly below the first row's window never matter — and over
        # the paged ring they alias newer pages, so they must not be read.
        first_page = max(0, (chunk_start + 1 - sliding_window) // page_size)
    last_page = -(-kv_end // page_size)
    phys = cache.page_table[slot, first_page:last_page]
    dtype = q.dtype
    k_band, v_band = _densify(cache, phys, dtype)
    band_len = kv_end - first_page * page_size
    k_band, v_band = k_band[:, :, :band_len], v_band[:, :, :band_len]
    kw = dict(
        causal=True, sm_scale=sm_scale, interpret=interpret,
        sliding_window=sliding_window, logit_softcap=logit_softcap,
    )
    if not attention_sinks or chunk_start + 1 - sliding_window <= 0:
        # No row's window has moved past the sinks: the band mask is exact.
        return flash_attention(q, k_band, v_band, **kw)

    # StreamingLLM: positions [0, sinks) stay visible to every row. The band
    # covers what the window shows; the sink term adds the sinks each row's
    # window has dropped, LSE-merged in the base-2 domain.
    o_band, lse_band = flash_attention(q, k_band, v_band, save_residuals=True,
                                       **kw)
    k_sink, v_sink = _densify(cache, cache.page_table[slot, :1], jnp.float32)
    k_sink = k_sink[:, :, :attention_sinks]
    v_sink = v_sink[:, :, :attention_sinks]
    group = q.shape[1] // k_sink.shape[1]
    k_sink = jnp.repeat(k_sink, group, axis=1)
    v_sink = jnp.repeat(v_sink, group, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q.astype(jnp.float32), k_sink,
                   precision=lax.Precision.HIGHEST)
    if logit_softcap is not None:
        s = jnp.tanh(s * (sm_scale / logit_softcap)) * (logit_softcap * LOG2E)
    else:
        s = s * (sm_scale * LOG2E)
    row = chunk_start + jnp.arange(chunk_len)[:, None]
    col = jnp.arange(attention_sinks)[None, :]
    dropped = jnp.logical_and(col <= row - sliding_window, col <= row)
    s = jnp.where(dropped, s, MASK_VALUE)
    m = jnp.maximum(jnp.max(s, axis=-1), M_FLOOR)
    p = jnp.exp2(s - m[..., None])
    l = jnp.sum(p, axis=-1)
    l_safe = jnp.where(l == 0.0, 1.0, l)
    o_sink = jnp.einsum("bhqk,bhkd->bhqd", p, v_sink,
                        precision=lax.Precision.HIGHEST) / l_safe[..., None]
    lse_sink = jnp.where(l == 0.0, -jnp.inf, m + jnp.log2(l_safe))
    o, _ = merge_two(o_band, lse_band, o_sink, lse_sink)
    return o.astype(q.dtype)


def paged_prefill_attention(
    q: jax.Array,
    cache: PagedKVCache,
    slot,
    kv_end,
    *,
    chunk_len: int,
    sm_scale: float | None = None,
    block_q: int | None = None,
    interpret: bool | None = None,
    logit_softcap: float | None = None,
    d64_unpadded: bool = False,
    sliding_window: int | None = None,
    attention_sinks: int = 0,
):
    """Causal chunk attention over a slot's paged KV.

    Args:
      q: [1, q_heads, chunk_len, head_dim] — the current prefill chunk, whose
        rows occupy positions [kv_end - chunk_len, kv_end). The chunk's own
        K/V must already be written to the cache.
      cache: PagedKVCache (plain or quantized payloads).
      slot: scalar int — the slot whose page table maps the KV.
      kv_end: exclusive end of the visible KV prefix, CONCRETE (a Python int
        or a concrete scalar array): it fixes the shape of the gathered band.
      chunk_len: static chunk length.
      block_q: accepted for interface stability; the forward kernel's tile
        choice applies.
      d64_unpadded: accepted for interface stability; nothing is padded.

    The chunk's visible pages — all of [0, kv_end), or with a sliding window
    only the band its rows can see (plus the pinned sink page) — are
    gathered into a dense, dequantized view that feeds the forward kernel.

    Returns:
      [1, q_heads, chunk_len, head_dim] attention output.
    """
    del block_q, d64_unpadded
    _, num_q_heads, t, _ = q.shape
    num_kv_heads = cache.k_pages.shape[1]
    if t != chunk_len:
        raise ValueError(f"q chunk length {t} != chunk_len {chunk_len}")
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if isinstance(kv_end, jax.core.Tracer):
        raise ValueError(
            "kv_end must be concrete: it sets the shape of the gathered page "
            "band (pass a Python int)"
        )
    end = int(kv_end)
    if end < chunk_len:
        raise ValueError(
            f"kv_end={end} < chunk_len={chunk_len}: the chunk's rows "
            f"occupy [kv_end - chunk_len, kv_end), which must not be negative"
        )
    if end > cache.pages_per_slot * cache.page_size:
        raise ValueError(
            f"kv_end={end} exceeds slot capacity "
            f"{cache.pages_per_slot} pages x {cache.page_size} rows"
        )
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if attention_sinks:
        if sliding_window is None:
            raise ValueError("attention_sinks requires sliding_window")
        if attention_sinks >= cache.page_size:
            raise ValueError(
                f"attention_sinks ({attention_sinks}) must fit the pinned "
                f"first page ({cache.page_size} rows)"
            )
    return _paged_prefill_attention_jit(
        q, cache, slot, kv_end=end, chunk_len=chunk_len, sm_scale=sm_scale,
        interpret=interpret, logit_softcap=logit_softcap,
        sliding_window=sliding_window, attention_sinks=attention_sinks,
    )


def _paged_decode_kernel(
    len_ref, table_ref, q_ref, k_ref, v_ref, *refs,
    sm_scale, softcap, window, sinks, quant, page_size, block_k, num_splits,
):
    """One program: one slot, one KV head, one split of the slot's pages.

    The program reads its slot's length and page-table row itself, walks its
    share of the live token range in ``block_k`` steps (each step lies inside
    one page), and keeps the (m, l, acc) online-softmax state for its GQA
    group's query rows in registers.
    """
    if quant:
        ks_ref, vs_ref, o_ref, lse_ref = refs
    else:
        o_ref, lse_ref = refs
    sp = pl.program_id(2)
    length = len_ref[0]
    q = q_ref[...]  # [Gp, D]

    def body(i, carry):
        acc, m, l = carry
        t0 = i * block_k
        phys = table_ref[lax.div(t0, page_size)]
        off = lax.rem(t0, page_size)
        k = k_ref[phys, pl.ds(off, block_k), :]
        s = pl.dot(q, k.astype(q.dtype), trans_b=True)  # [Gp, block_k]
        if quant:
            s = s * ks_ref[phys, pl.ds(off, block_k)][None, :]
        if softcap is None:
            s = s * (sm_scale * LOG2E)
        else:
            s = jnp.tanh(s * (sm_scale / softcap)) * (softcap * LOG2E)
        col = t0 + jnp.arange(block_k, dtype=jnp.int32)[None, :]
        ok = col < length
        if window is not None:
            vis = col >= length - window
            if sinks:
                vis = jnp.logical_or(vis, col < sinks)
            ok = jnp.logical_and(ok, vis)
        s = jnp.where(ok, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = alpha * l + jnp.sum(p, axis=1)
        if quant:
            p = p * vs_ref[phys, pl.ds(off, block_k)][None, :]
        v = v_ref[phys, pl.ds(off, block_k), :]
        acc = acc * alpha[:, None] + pl.dot(p.astype(q.dtype), v.astype(q.dtype))
        return acc, m_new, l

    # Live token steps [lo, hi) of this slot, split evenly across programs.
    hi = lax.div(length + (block_k - 1), block_k)
    lo = 0
    if window is not None:
        lo = lax.div(jnp.maximum(length - window, 0), block_k)
    per = lax.div(jnp.maximum(hi - lo, 0) + (num_splits - 1), num_splits)
    start = jnp.minimum(lo + sp * per, hi)
    stop = jnp.minimum(start + per, hi)
    carry = (
        jnp.zeros(q.shape, jnp.float32),
        jnp.full((q.shape[0],), M_FLOOR, jnp.float32),
        jnp.zeros((q.shape[0],), jnp.float32),
    )
    if sinks:
        # StreamingLLM: the pinned sink steps below the window band, read
        # once (by split 0).
        sink_stop = jnp.where(
            sp == 0, jnp.minimum(lo, (sinks + block_k - 1) // block_k), 0
        )
        carry = lax.fori_loop(0, sink_stop, body, carry)
    acc, m, l = lax.fori_loop(start, stop, body, carry)
    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = acc / l_safe[:, None]
    lse_ref[...] = jnp.where(empty, -jnp.inf, m + jnp.log2(l_safe))


def _decode_splits(num_slots: int, num_kv_heads: int, max_steps: int) -> int:
    """KV splits per (slot, head): enough programs for two waves on 132 SMs,
    never more splits than token steps."""
    programs = num_slots * num_kv_heads
    splits = 1
    while programs * splits < 264 and splits * 2 <= max(1, max_steps // 2):
        splits *= 2
    return splits


@functools.partial(
    jax.jit,
    static_argnames=(
        "sm_scale", "save_residuals", "interpret", "sliding_window",
        "logit_softcap", "d64_unpadded", "attention_sinks",
    ),
)
def paged_decode_attention(
    q: jax.Array,
    cache: PagedKVCache,
    *,
    sm_scale: float | None = None,
    save_residuals: bool = False,
    interpret: bool | None = None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    d64_unpadded: bool = False,
    attention_sinks: int = 0,
):
    """Single-token decode over the paged cache.

    Args:
      q: [num_slots, q_heads, head_dim] current-token queries (all slots; the
        caller masks out inactive slots via lengths == 0 or ignores outputs).
      cache: PagedKVCache; q_heads % kv_heads == 0 (a GQA group's query rows
        are the rows of one tile).
      d64_unpadded: accepted for interface stability; the kernel never pads
        head_dim.

    Returns:
      [num_slots, q_heads, head_dim] attention output (+ base-2 LSE
      [num_slots, q_heads] when save_residuals).
    """
    del d64_unpadded
    num_slots, num_q_heads, head_dim = q.shape
    num_pages, num_kv_heads, page_size, _ = cache.k_pages.shape
    pages_per_slot = cache.pages_per_slot
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if attention_sinks:
        if sliding_window is None:
            raise ValueError("attention_sinks requires sliding_window")
        if attention_sinks >= page_size:
            raise ValueError(
                f"attention_sinks ({attention_sinks}) must fit the pinned "
                f"first page ({page_size} rows)"
            )
    if page_size % 16:
        raise ValueError(f"page_size must be a multiple of 16, got {page_size}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    interpret = resolve_interpret(interpret)

    group = num_q_heads // num_kv_heads
    g_pad = max(16, next_pow2(group))
    d_pad = max(16, next_pow2(head_dim))
    # Largest power-of-two step (<= 128 rows) that tiles a page.
    block_k = 128
    while page_size % block_k:
        block_k //= 2
    quant = cache.quantized()

    qg = q.reshape(num_slots, num_kv_heads, group, head_dim)
    k_pages, v_pages = cache.k_pages, cache.v_pages
    if g_pad != group or d_pad != head_dim:
        qg = jnp.pad(
            qg, ((0, 0), (0, 0), (0, g_pad - group), (0, d_pad - head_dim))
        )
    if d_pad != head_dim:
        pads = ((0, 0), (0, 0), (0, 0), (0, d_pad - head_dim))
        k_pages, v_pages = jnp.pad(k_pages, pads), jnp.pad(v_pages, pads)
    table_w = next_pow2(pages_per_slot)
    table = jnp.pad(
        cache.page_table.astype(jnp.int32),
        ((0, 0), (0, table_w - pages_per_slot)),
    )
    lengths = cache.lengths.astype(jnp.int32).reshape(num_slots, 1)
    num_splits = _decode_splits(
        num_slots, num_kv_heads, pages_per_slot * page_size // block_k
    )

    pool = pl.BlockSpec(
        (num_pages, None, page_size, d_pad), lambda b, h, s: (0, h, 0, 0)
    )
    in_specs = [
        pl.BlockSpec((None, 1), lambda b, h, s: (b, 0)),
        pl.BlockSpec((None, table_w), lambda b, h, s: (b, 0)),
        pl.BlockSpec((None, None, g_pad, d_pad), lambda b, h, s: (b, h, 0, 0)),
        pool,
        pool,
    ]
    inputs = [lengths, table, qg, k_pages, v_pages]
    if quant:
        scales = pl.BlockSpec(
            (num_pages, None, None, page_size), lambda b, h, s: (0, h, 0, 0)
        )
        in_specs += [scales, scales]
        inputs += [cache.k_scales, cache.v_scales]
    out_shape = [
        jax.ShapeDtypeStruct(
            (num_slots, num_kv_heads, num_splits, g_pad, d_pad), jnp.float32
        ),
        jax.ShapeDtypeStruct(
            (num_slots, num_kv_heads, num_splits, g_pad), jnp.float32
        ),
    ]
    out_specs = [
        pl.BlockSpec((None, None, None, g_pad, d_pad),
                     lambda b, h, s: (b, h, s, 0, 0)),
        pl.BlockSpec((None, None, None, g_pad), lambda b, h, s: (b, h, s, 0)),
    ]
    kernel = functools.partial(
        _paged_decode_kernel,
        sm_scale=sm_scale, softcap=logit_softcap, window=sliding_window,
        sinks=attention_sinks, quant=quant, page_size=page_size,
        block_k=block_k, num_splits=num_splits,
    )
    with jax.named_scope("paged_decode_attention"):
        o_parts, lse_parts = pl.pallas_call(
            kernel,
            grid=(num_slots, num_kv_heads, num_splits),
            in_specs=in_specs,
            out_specs=out_specs,
            out_shape=out_shape,
            compiler_params=triton_params(num_warps=4, num_stages=3),
            interpret=interpret,
            backend="triton",
            name="paged_decode_attention",
        )(*inputs)
        if num_splits == 1:
            o, lse2 = o_parts[:, :, 0], lse_parts[:, :, 0]
        else:
            o, lse2 = merge_partial_attention(o_parts, lse_parts, axis=2)

    out = o[:, :, :group, :head_dim].astype(q.dtype).reshape(
        num_slots, num_q_heads, head_dim
    )
    if save_residuals:
        return out, lse2[:, :, :group].reshape(num_slots, num_q_heads)
    return out
