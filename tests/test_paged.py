"""Paged KV-cache attention tests: kernel vs oracle over scattered pages,
write paths, and the native page allocator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.paged import (
    PagedKVCache,
    init_paged_cache,
    paged_decode_attention,
    paged_write_prefill,
    paged_write_tokens,
    paged_write_tokens_multi,
)
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.serving.allocator import PageAllocator
from flash_attention_tpu.utils.testing import assert_close, make_qkv

PAGE = 128


def build_scattered_cache(seed, num_slots, kv_heads, lengths, pages_per_slot,
                          head_dim=128, num_pages=64):
    """Fill a paged cache with random K/V via a shuffled page table; returns
    (cache, dense_k, dense_v) where dense arrays are [S, H, max_len, D]."""
    rng = np.random.RandomState(seed)
    max_len = pages_per_slot * PAGE
    _, k, v = make_qkv(seed, num_slots, kv_heads, 1, head_dim, kv_seq=max_len)
    cache = init_paged_cache(
        num_pages=num_pages, num_slots=num_slots, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=PAGE, head_dim=head_dim,
    )
    # Scattered (shuffled) physical page assignment — the whole point of
    # paging is that logical pages land anywhere.
    phys = rng.permutation(num_pages)[: num_slots * pages_per_slot]
    table = phys.reshape(num_slots, pages_per_slot).astype(np.int32)
    k_pages = np.zeros(cache.k_pages.shape, np.float32)
    v_pages = np.zeros(cache.v_pages.shape, np.float32)
    for s in range(num_slots):
        for p in range(pages_per_slot):
            sl = slice(p * PAGE, (p + 1) * PAGE)
            k_pages[table[s, p]] = np.asarray(k[s, :, sl], np.float32)
            v_pages[table[s, p]] = np.asarray(v[s, :, sl], np.float32)
    cache = cache._replace(
        k_pages=jnp.asarray(k_pages, cache.k_pages.dtype),
        v_pages=jnp.asarray(v_pages, cache.v_pages.dtype),
        page_table=jnp.asarray(table),
        lengths=jnp.asarray(lengths, jnp.int32),
    )
    return cache, k, v


@pytest.mark.parametrize("group", [1, 4])
def test_paged_decode_matches_oracle(group):
    num_slots, kv_heads, pages_per_slot = 3, 2, 4
    lengths = np.array([512, 200, 37], np.int32)  # page-aligned, ragged, tiny
    cache, k, v = build_scattered_cache(0, num_slots, kv_heads, lengths, pages_per_slot)
    q, _, _ = make_qkv(7, num_slots, kv_heads * group, 1, 128)
    q = q[:, :, 0, :]

    got = paged_decode_attention(q, cache)
    want = reference_attention(
        q[:, :, None, :], k, v, kv_length=jnp.asarray(lengths)
    )[:, :, 0, :]
    assert_close(got, want)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_paged_decode_split_kv_matches(mode):
    """The decode kernel splits each slot's pages across programs and
    LSE-merges the splits: output and residual LSE must match the oracle
    (plain cache) and the dense decode on the same quantized cache."""
    from flash_attention_tpu.ops.decode import decode_attention
    from flash_attention_tpu.ops.quant import quantize_kv
    from flash_attention_tpu.ops.reference import reference_attention_with_lse

    num_slots, kv_heads, pages_per_slot = 2, 2, 4
    lengths = np.array([512, 200], np.int32)
    if mode == "none":
        cache, k, v = build_scattered_cache(
            4, num_slots, kv_heads, lengths, pages_per_slot
        )
        q, _, _ = make_qkv(9, num_slots, kv_heads * 2, 1, 128)
        q = q[:, :, 0, :]
        got, lse = paged_decode_attention(q, cache, save_residuals=True)
        want, want_lse = reference_attention_with_lse(
            q[:, :, None, :], k, v, kv_length=jnp.asarray(lengths)
        )
        assert_close(got, want[:, :, 0, :])
        np.testing.assert_allclose(
            np.asarray(lse), np.asarray(want_lse[:, :, 0]), atol=2e-2
        )
    else:
        _, k, v = make_qkv(13, num_slots, kv_heads, 1, 128,
                           kv_seq=pages_per_slot * PAGE)
        cache = init_paged_cache(
            num_pages=16, num_slots=num_slots, pages_per_slot=pages_per_slot,
            kv_heads=kv_heads, page_size=PAGE, kv_quant=mode,
        )
        cache = cache._replace(page_table=jnp.asarray(
            np.arange(1, 1 + num_slots * pages_per_slot).reshape(
                num_slots, pages_per_slot), jnp.int32))
        for s in range(num_slots):
            pref = ((int(lengths[s]) + PAGE - 1) // PAGE) * PAGE
            cache = paged_write_prefill(
                cache, k[s][:, :pref], v[s][:, :pref], s, int(lengths[s])
            )
        q, _, _ = make_qkv(14, num_slots, kv_heads * 2, 1, 128)
        q = q[:, :, 0, :]
        kq, vq = quantize_kv(k, v, mode)
        want = decode_attention(q, kq, vq, jnp.asarray(lengths))
        assert_close(paged_decode_attention(q, cache), want)


def test_paged_decode_residuals_match_dense():
    from flash_attention_tpu.ops.decode import decode_attention

    num_slots, kv_heads, pages_per_slot = 2, 2, 2
    lengths = np.array([256, 100], np.int32)
    cache, k, v = build_scattered_cache(1, num_slots, kv_heads, lengths, pages_per_slot)
    q, _, _ = make_qkv(8, num_slots, kv_heads, 1, 128)
    q = q[:, :, 0, :]
    o_p, lse_p = paged_decode_attention(q, cache, save_residuals=True)
    o_d, lse_d = decode_attention(
        q, k, v, jnp.asarray(lengths), block_kv=PAGE, save_residuals=True
    )
    assert_close(o_p, o_d)
    np.testing.assert_allclose(np.asarray(lse_p), np.asarray(lse_d), atol=2e-2)


def test_paged_write_prefill_and_tokens():
    kv_heads, pages_per_slot = 2, 4
    cache = init_paged_cache(
        num_pages=16, num_slots=2, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=PAGE,
    )
    cache = cache._replace(
        page_table=jnp.asarray([[5, 3, 9, 1], [0, 7, 2, 8]], jnp.int32)
    )
    # Prefill slot 0 with 150 real tokens (padded to 2 pages = 256).
    _, k, v = make_qkv(2, 1, kv_heads, 1, 128, kv_seq=256)
    cache = paged_write_prefill(cache, k[0], v[0], 0, 150)
    assert int(cache.lengths[0]) == 150
    q, _, _ = make_qkv(3, 2, kv_heads, 1, 128)
    q = q[:, :, 0, :]
    got = paged_decode_attention(q, cache)
    want = reference_attention(
        q[:1, :, None, :], k[:, :, :150], v[:, :, :150]
    )[:, :, 0, :]
    assert_close(got[:1], want)

    # Append 3 tokens one at a time to slot 0 (crossing nothing; pos 150..152)
    _, k_new, v_new = make_qkv(4, 3, kv_heads, 1, 128, kv_seq=1)
    k_new = k_new[:, :, 0, :]
    v_new = v_new[:, :, 0, :]
    for i in range(3):
        cache = paged_write_tokens(
            cache, k_new[i : i + 1], v_new[i : i + 1], jnp.asarray([0])
        )
    assert int(cache.lengths[0]) == 153
    got2 = paged_decode_attention(q, cache)
    k_full = jnp.concatenate([k[:, :, :150], k_new.transpose(1, 0, 2)[None]], axis=2)
    v_full = jnp.concatenate([v[:, :, :150], v_new.transpose(1, 0, 2)[None]], axis=2)
    want2 = reference_attention(q[:1, :, None, :], k_full, v_full)[:, :, 0, :]
    assert_close(got2[:1], want2)


def test_paged_write_crosses_page_boundary():
    kv_heads = 2
    cache = init_paged_cache(
        num_pages=8, num_slots=1, pages_per_slot=3, kv_heads=kv_heads, page_size=PAGE
    )
    cache = cache._replace(page_table=jnp.asarray([[4, 1, 6]], jnp.int32))
    # Fill to one token before the boundary, then append across it.
    _, k, v = make_qkv(5, 1, kv_heads, 1, 128, kv_seq=PAGE)
    cache = paged_write_prefill(cache, k[0], v[0], 0, PAGE - 1)
    _, k_new, v_new = make_qkv(6, 2, kv_heads, 1, 128, kv_seq=1)
    k_new, v_new = k_new[:, :, 0, :], v_new[:, :, 0, :]
    cache = paged_write_tokens(cache, k_new[:1], v_new[:1], jnp.asarray([0]))
    cache = paged_write_tokens(cache, k_new[1:], v_new[1:], jnp.asarray([0]))
    assert int(cache.lengths[0]) == PAGE + 1
    # Token at position PAGE-1 replaced nothing (was the padded row); token at
    # PAGE must live in physical page 1 (logical page 1 -> phys 1).
    q, _, _ = make_qkv(9, 1, kv_heads, 1, 128)
    q = q[:, :, 0, :]
    got = paged_decode_attention(q, cache)
    k_full = jnp.concatenate(
        [k[:, :, : PAGE - 1], k_new.transpose(1, 0, 2)[None]], axis=2
    )
    v_full = jnp.concatenate(
        [v[:, :, : PAGE - 1], v_new.transpose(1, 0, 2)[None]], axis=2
    )
    want = reference_attention(q[:, :, None, :], k_full, v_full)[:, :, 0, :]
    assert_close(got, want)


def test_page_allocator():
    a = PageAllocator(8)
    assert a.free_count == 8
    p1 = a.acquire(3)
    assert p1 is not None and len(set(p1)) == 3
    p2 = a.acquire(5)
    assert p2 is not None and not (set(p1) & set(p2))
    assert a.free_count == 0
    assert a.acquire(1) is None  # exhausted: all-or-nothing refusal
    a.release(p1)
    assert a.free_count == 3
    p3 = a.acquire(2)
    assert set(p3) <= set(p1)
    a.close()


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_quantized_decode_matches_dense(mode):
    """Quantized paged decode == quantized dense decode on identical content."""
    import jax.numpy as jnp

    from flash_attention_tpu.ops.decode import decode_attention
    from flash_attention_tpu.ops.paged import (
        init_paged_cache,
        paged_decode_attention,
        paged_write_prefill,
        paged_write_tokens,
    )
    from flash_attention_tpu.ops.quant import quantize_kv

    kv_heads, pps = 2, 3
    lengths = np.array([256, 130], np.int32)
    _, k, v = make_qkv(11, 2, kv_heads, 1, 128, kv_seq=pps * PAGE)
    cache = init_paged_cache(
        num_pages=12, num_slots=2, pages_per_slot=pps, kv_heads=kv_heads,
        page_size=PAGE, kv_quant=mode,
    )
    cache = cache._replace(
        page_table=jnp.asarray([[7, 2, 9], [4, 0, 11]], jnp.int32)
    )
    # Prefill to one token short, then append one token (exercises both
    # quantizing write paths).
    for s in range(2):
        pref = ((lengths[s] - 1 + PAGE - 1) // PAGE) * PAGE
        pref = max(pref, PAGE)
        cache = paged_write_prefill(
            cache, k[s][:, :pref], v[s][:, :pref], s, int(lengths[s]) - 1
        )
    last = jnp.stack([k[0][:, lengths[0] - 1], k[1][:, lengths[1] - 1]])
    lastv = jnp.stack([v[0][:, lengths[0] - 1], v[1][:, lengths[1] - 1]])
    cache = paged_write_tokens(cache, last, lastv, jnp.asarray([0, 1]))
    assert [int(x) for x in cache.lengths] == list(lengths)

    q, _, _ = make_qkv(12, 2, kv_heads * 2, 1, 128)
    q = q[:, :, 0, :]
    got = paged_decode_attention(q, cache)
    kq, vq = quantize_kv(k, v, mode)
    want = decode_attention(q, kq, vq, jnp.asarray(lengths), block_kv=PAGE)
    assert_close(got, want)


@pytest.mark.parametrize("quant", ["none", "int8", "fp8_e4m3"])
def test_paged_prefill_matches_gather_path(quant):
    """The in-place paged prefill kernel must match the dense-gather path
    (chunk attention over densified visible KV) across chunk offsets, GQA,
    and quantized payloads."""
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.paged import (
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )

    kv_heads, q_heads = 2, 4
    pages_per_slot, chunk = 4, 256  # 2 pages per chunk, 2 chunks total
    max_len = pages_per_slot * PAGE
    cache = init_paged_cache(
        num_pages=16, num_slots=2, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=PAGE, kv_quant=quant,
    )
    rng = np.random.RandomState(5)
    table = rng.permutation(16)[: 2 * pages_per_slot].reshape(2, pages_per_slot)
    cache = cache._replace(page_table=jnp.asarray(table, jnp.int32))

    q_full, k_full, v_full = make_qkv(31, 1, q_heads, max_len, 128,
                                      num_kv_heads=kv_heads)
    slot = 1
    for c in range(max_len // chunk):
        start = c * chunk
        kv_end = start + chunk
        cache = paged_write_prefill(
            cache, k_full[0, :, start:kv_end], v_full[0, :, start:kv_end],
            slot, kv_end, start=start,
        )
        q_chunk = q_full[:, :, start:kv_end]
        got = paged_prefill_attention(
            q_chunk, cache, slot, jnp.int32(kv_end), chunk_len=chunk
        )
        k_vis, v_vis = paged_gather_kv(cache, slot, kv_end)
        want = flash_attention(q_chunk, k_vis, v_vis, causal=True)
        # Quantized: both paths see the same quantized cache, so they agree
        # to kernel tolerance; vs the fp32 oracle the quantization error
        # dominates but stays inside the reference 0.1 bar.
        assert_close(got, want, msg=f"quant={quant} chunk={c}")
        oracle = reference_attention(
            q_full[:, :, start:kv_end].astype(jnp.float32),
            k_full[:, :, :kv_end].astype(jnp.float32),
            v_full[:, :, :kv_end].astype(jnp.float32),
            causal=True,
        )
        assert_close(got, oracle, msg=f"quant={quant} chunk={c} vs oracle")


def test_paged_prefill_window_matches_gather_path():
    """Sliding-window in-place paged prefill: band-limited page walk must
    match the dense-gather window path chunk by chunk (windows crossing
    page and chunk boundaries)."""
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.paged import (
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )

    kv_heads, q_heads = 2, 4
    pages_per_slot, chunk, window = 4, 128, 200  # band spans ~2-3 pages
    max_len = pages_per_slot * PAGE
    cache = init_paged_cache(
        num_pages=16, num_slots=2, pages_per_slot=pages_per_slot,
        kv_heads=kv_heads, page_size=PAGE, kv_quant="none",
    )
    rng = np.random.RandomState(6)
    table = rng.permutation(16)[: 2 * pages_per_slot].reshape(2, pages_per_slot)
    cache = cache._replace(page_table=jnp.asarray(table, jnp.int32))

    q_full, k_full, v_full = make_qkv(32, 1, q_heads, max_len, 128,
                                      num_kv_heads=kv_heads)
    slot = 0
    for c in range(max_len // chunk):
        start = c * chunk
        kv_end = start + chunk
        cache = paged_write_prefill(
            cache, k_full[0, :, start:kv_end], v_full[0, :, start:kv_end],
            slot, kv_end, start=start,
        )
        q_chunk = q_full[:, :, start:kv_end]
        got = paged_prefill_attention(
            q_chunk, cache, slot, jnp.int32(kv_end), chunk_len=chunk,
            sliding_window=window,
        )
        k_vis, v_vis = paged_gather_kv(cache, slot, kv_end)
        want = flash_attention(
            q_chunk, k_vis, v_vis, causal=True, sliding_window=window
        )
        assert_close(got, want, msg=f"window chunk={c}")


def test_paged_decode_head_dim_64_unpadded():
    """d64_unpadded: 64-wide pages stay 64-wide in-kernel (no per-step page
    pool pad copy); must match the padded path and the oracle."""
    lengths = np.array([512, 200], np.int32)
    cache, k, v = build_scattered_cache(6, 2, 2, lengths, 4, head_dim=64)
    q, _, _ = make_qkv(10, 2, 4, 1, 64)
    q = q[:, :, 0, :]
    got = paged_decode_attention(q, cache, d64_unpadded=True)
    want = reference_attention(
        q[:, :, None, :], k, v, kv_length=jnp.asarray(lengths)
    )[:, :, 0, :]
    assert_close(got, want)
    padded = paged_decode_attention(q, cache)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(padded, np.float32), atol=2e-2
    )


def test_paged_prefill_head_dim_64_unpadded():
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.paged import (
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )

    cache = init_paged_cache(
        num_pages=8, num_slots=1, pages_per_slot=4, kv_heads=2,
        page_size=PAGE, head_dim=64,
    )
    cache = cache._replace(page_table=jnp.asarray([[3, 1, 6, 0]], jnp.int32))
    q, k, v = make_qkv(11, 1, 2, 512, 64)
    cache = paged_write_prefill(cache, k[0], v[0], 0, 512, start=0)
    got = paged_prefill_attention(
        q, cache, 0, jnp.int32(512), chunk_len=512, d64_unpadded=True
    )
    k_vis, v_vis = paged_gather_kv(cache, 0, 512)
    want = flash_attention(q, k_vis, v_vis, causal=True)
    assert_close(got, want)


def test_paged_decode_rejects_nonpositive_window():
    lengths = np.array([256, 100], np.int32)
    cache, _, _ = build_scattered_cache(3, 2, 2, lengths, 2)
    q, _, _ = make_qkv(8, 2, 4, 1, 128)
    q = q[:, :, 0, :]
    with pytest.raises(ValueError, match="sliding_window"):
        paged_decode_attention(q, cache, sliding_window=0)


def test_paged_prefill_default_block_q_non_dividing_chunk():
    """chunk_len=768 is a legal page multiple that 512 does not divide: the
    default block_q must fall back to a divisor (384), not raise. Regression
    for the blind min(chunk_len, 512) default that crashed
    PagedServingEngine(prefill_chunk=768)."""
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.paged import (
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )

    chunk = 768
    cache = init_paged_cache(
        num_pages=8, num_slots=1, pages_per_slot=6, kv_heads=2,
        page_size=PAGE,
    )
    cache = cache._replace(
        page_table=jnp.asarray([[5, 2, 7, 1, 4, 3]], jnp.int32)
    )
    q, k, v = make_qkv(33, 1, 2, chunk, 128)
    cache = paged_write_prefill(cache, k[0], v[0], 0, chunk, start=0)
    got = paged_prefill_attention(q, cache, 0, jnp.int32(chunk), chunk_len=chunk)
    k_vis, v_vis = paged_gather_kv(cache, 0, chunk)
    want = flash_attention(q, k_vis, v_vis, causal=True)
    assert_close(got, want)


def test_paged_prefill_softcap():
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.paged import (
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )

    cache = init_paged_cache(
        num_pages=8, num_slots=1, pages_per_slot=4, kv_heads=2,
        page_size=PAGE,
    )
    cache = cache._replace(
        page_table=jnp.asarray([[5, 2, 7, 0]], jnp.int32)
    )
    q, k, v = make_qkv(32, 1, 2, 512, 128)
    cache = paged_write_prefill(cache, k[0], v[0], 0, 512, start=0)
    got = paged_prefill_attention(
        q, cache, 0, jnp.int32(512), chunk_len=512, logit_softcap=25.0
    )
    k_vis, v_vis = paged_gather_kv(cache, 0, 512)
    want = flash_attention(q, k_vis, v_vis, causal=True, logit_softcap=25.0)
    assert_close(got, want)


def test_paged_prefill_rejects_bad_kv_end():
    """A concrete kv_end below chunk_len (negative chunk_start) or beyond
    the slot capacity must raise instead of returning silent zeros."""
    from flash_attention_tpu.ops.paged import paged_prefill_attention

    cache = init_paged_cache(
        num_pages=8, num_slots=2, pages_per_slot=4, kv_heads=2,
        page_size=128, head_dim=128,
    )
    q = jnp.zeros((1, 4, 256, 128), jnp.bfloat16)
    with pytest.raises(ValueError, match="kv_end"):
        paged_prefill_attention(q, cache, 0, 128, chunk_len=256)
    with pytest.raises(ValueError, match="capacity"):
        paged_prefill_attention(q, cache, 0, 4096, chunk_len=256)


def test_paged_write_tokens_at_capacity_drops():
    """A slot at page-table capacity must DROP the write and freeze its
    length: clamping only the page index would wrap the offset to 0 and
    overwrite the LIVE row at position (pages_per_slot-1)*page_size."""
    from flash_attention_tpu.ops.paged import paged_write_tokens

    cache = init_paged_cache(
        num_pages=4, num_slots=2, pages_per_slot=2, kv_heads=1,
        page_size=128, head_dim=128,
    )
    cache = cache._replace(
        page_table=jnp.asarray([[1, 2], [3, 3]], jnp.int32),
        lengths=jnp.asarray([256, 10], jnp.int32),  # slot 0 AT capacity
    )
    k_sent = jnp.full((2, 1, 128), 7.0, jnp.bfloat16)
    before_live_row = np.asarray(cache.k_pages[2, 0, 0])
    new = paged_write_tokens(cache, k_sent, k_sent, jnp.asarray([0, 1]))
    # Slot 0: nothing written anywhere, length frozen at capacity.
    np.testing.assert_array_equal(np.asarray(new.k_pages[2, 0, 0]), before_live_row)
    assert int(new.lengths[0]) == 256
    # Slot 1 (in range) still works: row at pos 10 of its page written.
    assert float(new.k_pages[3, 0, 10, 0]) == 7.0
    assert int(new.lengths[1]) == 11


def test_paged_write_tokens_multi_matches_singles():
    """One multi-layer scatter call == L independent per-layer writes."""
    from flash_attention_tpu.ops.paged import (
        init_paged_cache, paged_write_tokens, paged_write_tokens_multi,
    )

    for kv_quant in ("none", "int8"):
        L, slots, H, D, page = 3, 4, 2, 128, 128
        caches = []
        for j in range(L):
            c = init_paged_cache(
                num_pages=9, num_slots=slots, pages_per_slot=2,
                kv_heads=H, page_size=page, kv_quant=kv_quant,
            )
            table = np.asarray(
                [[1 + 2 * s, 2 + 2 * s] for s in range(slots)], np.int32
            )
            c = c._replace(
                page_table=jnp.asarray(table),
                # One slot at capacity (frozen), the rest mid-page.
                lengths=jnp.asarray([5, 130, 2 * page, 127], jnp.int32),
            )
            caches.append(c)
        ks = [
            jnp.asarray(
                np.random.RandomState(40 + j).uniform(-0.5, 0.5, (slots, H, D)),
                jnp.bfloat16,
            )
            for j in range(L)
        ]
        vs = [
            jnp.asarray(
                np.random.RandomState(50 + j).uniform(-0.5, 0.5, (slots, H, D)),
                jnp.bfloat16,
            )
            for j in range(L)
        ]
        slots_arr = jnp.arange(slots)
        singles = [
            paged_write_tokens(c, k1, v1, slots_arr)
            for c, k1, v1 in zip(caches, ks, vs)
        ]
        multi = paged_write_tokens_multi(caches, ks, vs, slots_arr)
        for j in range(L):
            for field in ("k_pages", "v_pages", "lengths", "k_scales", "v_scales"):
                a = getattr(singles[j], field)
                b = getattr(multi[j], field)
                if a is None:
                    assert b is None
                    continue
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b),
                    err_msg=f"{kv_quant} layer {j} {field}",
                )


def test_deferred_decode_matches_write_first():
    """decode_step_logits_paged's deferred-write path (self-token LSE merge
    + one multi-layer write) must match the write-first path: same token
    stream and same cache contents after several steps."""
    from flash_attention_tpu.models.transformer import (
        ModelConfig, init_model_params, init_paged_caches,
        decode_step_logits_paged, prefill_paged, _trunk,
    )
    from flash_attention_tpu.models.attention import attention_decode_paged

    cfg = ModelConfig.tiny(kv_quant="none")
    params = init_model_params(jax.random.key(0), cfg)
    page = 128
    caches = init_paged_caches(
        cfg, num_pages=5, num_slots=2, pages_per_slot=2, page_size=page,
    )
    table = np.asarray([[1, 2], [3, 4]], np.int32)
    caches = [c._replace(page_table=jnp.asarray(table)) for c in caches]
    toks = jnp.asarray(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, page))
    )
    for slot in range(2):
        _, caches = prefill_paged(
            params, cfg, toks[slot : slot + 1], caches, slot, page - 7
        )
    caches = [
        c._replace(lengths=jnp.asarray([page - 7, page - 7], jnp.int32))
        for c in caches
    ]

    def write_first_step(params, cfg, tokens, caches):
        logits, new_caches = _trunk(
            params, cfg, tokens, attention_decode_paged, caches
        )
        return logits[:, -1, :], new_caches

    cur = jnp.asarray([[3], [5]], jnp.int32)
    c_a = [jax.tree_util.tree_map(jnp.copy, c) for c in caches]
    c_b = [jax.tree_util.tree_map(jnp.copy, c) for c in caches]
    ta, tb = cur, cur
    for _ in range(3):
        la, c_a = decode_step_logits_paged(params, cfg, ta, c_a)
        lb, c_b = write_first_step(params, cfg, tb, c_b)
        na = jnp.argmax(la, axis=-1)[:, None].astype(jnp.int32)
        nb = jnp.argmax(lb, axis=-1)[:, None].astype(jnp.int32)
        np.testing.assert_array_equal(np.asarray(na), np.asarray(nb))
        ta, tb = na, nb
        np.testing.assert_array_equal(
            np.asarray(c_a[0].lengths), np.asarray(c_b[0].lengths)
        )
    # Cache payloads agree (same tokens written at the same positions; a
    # few bf16 ulps of slack — the two paths fuse the k projection into
    # different consumers, so last-bit roundings can differ).
    for ca, cb in zip(c_a, c_b):
        np.testing.assert_allclose(
            np.asarray(ca.k_pages, np.float32),
            np.asarray(cb.k_pages, np.float32), atol=0.05,
        )


def _full_buffer_moves(compiled_text, n_elements):
    """copy / transpose instructions that produce a whole cache buffer."""
    import math
    import re

    moves = []
    for line in compiled_text.splitlines():
        m = re.search(r"= \w+\[([\d,]+)\]\S* (copy|transpose)\(", line)
        if m and math.prod(int(x) for x in m.group(1).split(",")) == n_elements:
            moves.append(line.strip())
    return moves


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("mode", ["none", "int8"])
def test_token_writes_scatter_in_place(paged, mode):
    """A decode step's one-token writes update the donated cache in place:
    the compiled program moves no whole cache buffer (indexing page or batch
    and row with a slice between them made XLA transpose every pool there
    and back, which dominated the write on the GPU)."""
    from flash_attention_tpu.models.attention import (
        AttentionConfig,
        init_kv_cache,
        write_cache,
    )

    slots, kv_heads, d = 4, 2, 128
    k1 = make_qkv(70, slots, kv_heads, 1, d)[1]
    if paged:
        cache = init_paged_cache(
            num_pages=17, num_slots=slots, pages_per_slot=4,
            kv_heads=kv_heads, page_size=128, kv_quant=mode,
        )
        cache = cache._replace(
            page_table=(1 + jnp.arange(16, dtype=jnp.int32)).reshape(slots, 4),
            lengths=jnp.array([0, 130, 300, 511], jnp.int32),
        )
        layers = [cache, jax.tree_util.tree_map(jnp.copy, cache)]
        step = jax.jit(lambda cs: paged_write_tokens_multi(
            cs, [k1[:, :, 0]] * 2, [k1[:, :, 0]] * 2, jnp.arange(slots)),
            donate_argnums=0)
        n = cache.k_pages.size
    else:
        cfg = AttentionConfig(model_dim=256, num_q_heads=4,
                              num_kv_heads=kv_heads, head_dim=d, kv_quant=mode)
        layers = init_kv_cache(cfg, slots, 512)
        step = jax.jit(lambda c: write_cache(
            cfg, c, k1, k1, jnp.array([0, 130, 300, 511], jnp.int32)),
            donate_argnums=0)
        n = layers.k.size
    text = step.lower(layers).compile().as_text()
    assert _full_buffer_moves(text, n) == []
