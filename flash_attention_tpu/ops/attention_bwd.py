"""Flash-attention backward kernels (Pallas, Triton route, for Hopper).

The reference has no backward pass (SURVEY.md §2); this is new capability
under the same numerics contract. Two kernels, each owning its output tile so
that no two programs ever write the same rows (Hopper runs programs in
parallel, in no order):

  * ``dkv``: one program per (KV head, KV tile) holds K and V and loops over
    every Q tile of every Q head of its GQA group, accumulating dK and dV in
    fp32 registers;
  * ``dq``: one program per (Q head, Q tile) holds Q, dO, the LSE and
    delta = rowsum(dO ∘ O) and loops over the KV tiles, accumulating dQ.

Both recompute P = exp2(s·scale·log2e − lse2) from the forward's base-2 LSE
residual, split their loop into a mask-free middle and masked edges exactly
like the forward, and narrow packed inputs to the tiles whose segment ids can
match. Rows with no visible key (lse2 = -inf) contribute nothing: their LSE
is replaced by +inf, so P underflows to 0.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from flash_attention_tpu.ops.common import (
    MASK_VALUE,
    ceil_to,
    next_pow2,
    triton_params,
)
from flash_attention_tpu.ops.flash_attention import (
    _cdiv,
    _kv_ranges,
    _logits,
    _visible,
    pad_segments,
    segment_block_bounds,
    tile_loop,
)
from flash_attention_tpu.ops.tuning import BlockSizes, clamp_to_seq


def _probs_and_dlogits(q, k, v, do, lse, delta, ok, *, sm_scale, softcap):
    """P and dL/d(QKᵀ) of one (Q tile, KV tile) pair."""
    s, t = _logits(pl.dot(q, k, trans_b=True), sm_scale=sm_scale,
                   softcap=softcap)
    if ok is not None:
        s = jnp.where(ok, s, MASK_VALUE)
    p = jnp.exp2(s - lse[:, None])
    dp = pl.dot(do, v, trans_b=True)
    ds = p * (dp - delta[:, None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    return p, ds * sm_scale


def _dq_kernel(
    q_ref, do_ref, lse_ref, delta_ref, k_ref, v_ref, *refs,
    sm_scale, causal, window, softcap, packed, q_len, kv_len, kv_pad,
    block_q, block_kv,
):
    if packed:
        segq_ref, segkv_ref, bounds_ref, dq_ref = refs
    else:
        (dq_ref,) = refs
    iq = pl.program_id(1)
    r0 = iq * block_q + (kv_len - q_len)
    q = q_ref[...]
    do = do_ref[...]
    lse = lse_ref[...]
    delta = delta_ref[...]
    seg_q = segq_ref[...] if packed else None
    rows = r0 + jnp.arange(block_q, dtype=jnp.int32)[:, None]

    def body(j, dq, masked):
        start = j * block_kv
        k = k_ref[pl.ds(start, block_kv), :]
        v = v_ref[pl.ds(start, block_kv), :]
        ok = None
        if masked:
            cols = start + jnp.arange(block_kv, dtype=jnp.int32)[None, :]
            seg_kv = segkv_ref[pl.ds(start, block_kv)] if packed else None
            ok = _visible(rows, cols, kv_len=kv_len, kv_pad=kv_pad,
                          causal=causal, window=window, seg_q=seg_q,
                          seg_kv=seg_kv)
        _, ds = _probs_and_dlogits(q, k, v, do, lse, delta, ok,
                                   sm_scale=sm_scale, softcap=softcap)
        return dq + pl.dot(ds.astype(k.dtype), k)

    ranges = _kv_ranges(
        r0, block_q=block_q, block_kv=block_kv,
        num_kv_blocks=kv_pad // block_kv, kv_len=kv_len, causal=causal,
        window=window,
        seg_bounds=(bounds_ref[0], bounds_ref[1]) if packed else None,
    )
    dq = tile_loop(ranges, body, jnp.zeros(q.shape, jnp.float32), packed=packed)
    dq_ref[...] = dq.astype(dq_ref.dtype)


def _q_ranges(c0, *, block_q, block_kv, num_q_blocks, diag, causal, window,
              seg_bounds=None):
    """Q tile ranges that see the KV tile whose first column is c0.

    ``diag`` = kv_len - q_len (query x sits at KV position x + diag).
    Returns (lo, a, b, hi) as in flash_attention._kv_ranges.
    """
    lo = 0
    full_lo = 0
    hi = num_q_blocks
    full_hi = num_q_blocks
    if causal:
        # Rows at positions >= c0 see the tile; rows >= its last column see
        # all of it.
        lo = lax.div(jnp.maximum(c0 - diag, 0), block_q)
        full_lo = _cdiv(jnp.maximum(c0 + block_kv - 1 - diag, 0), block_q)
    if window is not None:
        # Row r sees column c while c > r - window.
        last = c0 + block_kv + window - 2 - diag
        hi = jnp.minimum(
            jnp.where(last < 0, 0, lax.div(jnp.maximum(last, 0), block_q) + 1),
            num_q_blocks,
        )
        fully = c0 + window - block_q - diag
        full_hi = jnp.where(
            fully < 0, 0, lax.div(jnp.maximum(fully, 0), block_q) + 1
        )
    if seg_bounds is not None:
        lo = jnp.maximum(lo, seg_bounds[0])
        hi = jnp.minimum(hi, seg_bounds[1])
    a = jnp.minimum(jnp.maximum(full_lo, lo), hi)
    b = jnp.maximum(a, jnp.minimum(full_hi, hi))
    return lo, a, b, hi


def _dkv_kernel(
    k_ref, v_ref, q_ref, do_ref, lse_ref, delta_ref, *refs,
    sm_scale, causal, window, softcap, packed, group, q_len, q_pad, kv_len,
    block_q, block_kv,
):
    if packed:
        segkv_ref, segq_ref, bounds_ref, dk_ref, dv_ref = refs
    else:
        dk_ref, dv_ref = refs
    j = pl.program_id(1)
    c0 = j * block_kv
    diag = kv_len - q_len
    k = k_ref[...]
    v = v_ref[...]
    seg_kv = segkv_ref[...] if packed else None
    cols = c0 + jnp.arange(block_kv, dtype=jnp.int32)[None, :]

    def body(i, carry, g, masked):
        dk, dv = carry
        start = i * block_q
        row0 = g * q_pad + start  # row of head g's tile in the group slab
        q = q_ref[pl.ds(row0, block_q), :]
        do = do_ref[pl.ds(row0, block_q), :]
        lse = lse_ref[pl.ds(row0, block_q)]
        delta = delta_ref[pl.ds(row0, block_q)]
        ok = None
        if masked:
            rows = start + diag + jnp.arange(block_q, dtype=jnp.int32)[:, None]
            seg_q = segq_ref[pl.ds(start, block_q)] if packed else None
            # Padded KV columns own discarded rows of dK/dV: no mask needed.
            ok = _visible(rows, cols, kv_len=kv_len, kv_pad=kv_len,
                          causal=causal, window=window, seg_q=seg_q,
                          seg_kv=seg_kv)
        p, ds = _probs_and_dlogits(q, k, v, do, lse, delta, ok,
                                   sm_scale=sm_scale, softcap=softcap)
        dv = dv + pl.dot(p.astype(do.dtype), do, trans_a=True)
        dk = dk + pl.dot(ds.astype(q.dtype), q, trans_a=True)
        return dk, dv

    ranges = _q_ranges(
        c0, block_q=block_q, block_kv=block_kv,
        num_q_blocks=q_pad // block_q, diag=diag, causal=causal,
        window=window,
        seg_bounds=(bounds_ref[0], bounds_ref[1]) if packed else None,
    )

    def per_head(g, carry):
        return tile_loop(
            ranges, functools.partial(body, g=g), carry, packed=packed
        )

    zeros = jnp.zeros(k.shape, jnp.float32)
    dk, dv = lax.fori_loop(0, group, per_head, (zeros, zeros))
    dk_ref[...] = dk.astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def flash_attention_bwd(
    q, k, v, out, lse2, do, *,
    causal: bool,
    sm_scale: float,
    block_sizes: BlockSizes,
    interpret: bool,
    window: int | None = None,
    softcap: float | None = None,
    segments=None,
):
    """(dq, dk, dv) of attention given the forward's output and base-2 LSE.

    q: [B, Hq, Sq, D]; k, v: [B, Hkv, Skv, D]; out, do: like q; lse2:
    [B, Hq, Sq]. Gradients come back in the input dtypes.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    group = num_q_heads // num_kv_heads
    bs = clamp_to_seq(block_sizes, q_len, kv_len)
    block_q, block_kv = bs.block_q, bs.block_kv
    q_pad = ceil_to(q_len, block_q)
    kv_pad = ceil_to(kv_len, block_kv)
    d_pad = max(16, next_pow2(head_dim))
    num_q_blocks = q_pad // block_q
    num_kv_blocks = kv_pad // block_kv

    delta = jnp.sum(
        out.astype(jnp.float32) * do.astype(jnp.float32), axis=-1
    )  # [B, Hq, Sq]
    # Rows that saw no key have lse2 = -inf; +inf makes their P exactly 0.
    lse = jnp.where(jnp.isneginf(lse2), jnp.inf, lse2.astype(jnp.float32))

    def rows_of(x, heads, seq, seq_pad):
        x = x.reshape(batch * heads, seq, head_dim)
        if seq_pad != seq or d_pad != head_dim:
            x = jnp.pad(x, ((0, 0), (0, seq_pad - seq), (0, d_pad - head_dim)))
        return x

    qq = rows_of(q, num_q_heads, q_len, q_pad)
    dd = rows_of(do.astype(q.dtype), num_q_heads, q_len, q_pad)
    kk = rows_of(k, num_kv_heads, kv_len, kv_pad)
    vv = rows_of(v, num_kv_heads, kv_len, kv_pad)
    # Padded query rows: lse +inf and dO 0, so they contribute nothing.
    lse = jnp.pad(
        lse.reshape(batch * num_q_heads, q_len), ((0, 0), (0, q_pad - q_len)),
        constant_values=jnp.inf,
    )
    delta = jnp.pad(
        delta.reshape(batch * num_q_heads, q_len), ((0, 0), (0, q_pad - q_len))
    )

    packed = segments is not None
    if packed:
        seg_q, seg_kv = pad_segments(segments, q_len, q_pad, kv_len, kv_pad)
        q_bounds, kv_bounds = segment_block_bounds(
            seg_q, seg_kv, block_q, block_kv, q_len, kv_len
        )
    statics = dict(
        sm_scale=sm_scale, causal=causal, window=window, softcap=softcap,
        packed=packed, q_len=q_len, kv_len=kv_len, block_q=block_q,
        block_kv=block_kv,
    )
    params = triton_params(bs.num_warps, bs.num_stages)

    # ---- dq: one program per (Q head, Q tile), loop over KV tiles ----
    def kv_row(bh):
        return (bh // num_q_heads) * num_kv_heads + (bh % num_q_heads) // group

    q_tile = pl.BlockSpec((None, block_q, d_pad), lambda bh, i: (bh, i, 0))
    q_vec = pl.BlockSpec((None, block_q), lambda bh, i: (bh, i))
    kv_full = pl.BlockSpec(
        (None, kv_pad, d_pad), lambda bh, i: (kv_row(bh), 0, 0)
    )
    in_specs = [q_tile, q_tile, q_vec, q_vec, kv_full, kv_full]
    inputs = [qq, dd, lse, delta, kk, vv]
    if packed:
        b_of = lambda bh: bh // num_q_heads  # noqa: E731
        in_specs += [
            pl.BlockSpec((None, block_q), lambda bh, i: (b_of(bh), i)),
            pl.BlockSpec((None, kv_pad), lambda bh, i: (b_of(bh), 0)),
            pl.BlockSpec((None, None, 2), lambda bh, i: (b_of(bh), i, 0)),
        ]
        inputs += [seg_q, seg_kv, q_bounds]
    with jax.named_scope("flash_attention_bwd_dq"):
        dq = pl.pallas_call(
            functools.partial(_dq_kernel, kv_pad=kv_pad, **statics),
            grid=(batch * num_q_heads, num_q_blocks),
            in_specs=in_specs,
            out_specs=q_tile,
            out_shape=jax.ShapeDtypeStruct(qq.shape, q.dtype),
            compiler_params=params,
            interpret=interpret,
            backend="triton",
            name="flash_attention_bwd_dq",
        )(*inputs)

    # ---- dkv: one program per (KV head, KV tile), loop over Q tiles of
    # every Q head of the group. [B*Hq, Sq_pad, D] -> [B*Hkv, G*Sq_pad, D]
    # is free: a group's heads are adjacent. ----
    qg = qq.reshape(batch * num_kv_heads, group * q_pad, d_pad)
    dg = dd.reshape(batch * num_kv_heads, group * q_pad, d_pad)
    lse_g = lse.reshape(batch * num_kv_heads, group * q_pad)
    delta_g = delta.reshape(batch * num_kv_heads, group * q_pad)
    kv_tile = pl.BlockSpec((None, block_kv, d_pad), lambda bh, j: (bh, j, 0))
    slab = pl.BlockSpec((None, group * q_pad, d_pad), lambda bh, j: (bh, 0, 0))
    slab_vec = pl.BlockSpec((None, group * q_pad), lambda bh, j: (bh, 0))
    in_specs = [kv_tile, kv_tile, slab, slab, slab_vec, slab_vec]
    inputs = [kk, vv, qg, dg, lse_g, delta_g]
    if packed:
        b_of = lambda bh: bh // num_kv_heads  # noqa: E731
        in_specs += [
            pl.BlockSpec((None, block_kv), lambda bh, j: (b_of(bh), j)),
            pl.BlockSpec((None, q_pad), lambda bh, j: (b_of(bh), 0)),
            pl.BlockSpec((None, None, 2), lambda bh, j: (b_of(bh), j, 0)),
        ]
        inputs += [seg_kv, seg_q, kv_bounds]
    with jax.named_scope("flash_attention_bwd_dkv"):
        dk, dv = pl.pallas_call(
            functools.partial(_dkv_kernel, group=group, q_pad=q_pad, **statics),
            grid=(batch * num_kv_heads, num_kv_blocks),
            in_specs=in_specs,
            out_specs=[kv_tile, kv_tile],
            out_shape=[
                jax.ShapeDtypeStruct(kk.shape, k.dtype),
                jax.ShapeDtypeStruct(vv.shape, v.dtype),
            ],
            compiler_params=params,
            interpret=interpret,
            backend="triton",
            name="flash_attention_bwd_dkv",
        )(*inputs)

    dq = dq[:, :q_len, :head_dim].reshape(q.shape)
    dk = dk[:, :kv_len, :head_dim].reshape(k.shape)
    dv = dv[:, :kv_len, :head_dim].reshape(v.shape)
    return dq, dk, dv
