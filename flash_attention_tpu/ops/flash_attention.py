"""Fused flash-attention forward kernel (Pallas, Triton route, for Hopper).

Re-design of the reference's ``flash_attention_v9`` CUDA kernel (C4,
flash_attention.cu:67-554) — the same algorithm (blockwise QKᵀ → online
softmax → PV with fp32 running (m, l, acc) state), written for one Triton
program per (head, Q tile):

  * the warp's Q slice held in registers across the whole KV loop
    (flash_attention.cu:145-159) is the program's Q tile, loaded once and
    held across an in-kernel ``fori_loop`` over KV tiles;
  * mma.sync.m16n8k16 tiles with fp32 accumulation (flash_attention.cu:
    223-231) are ``pl.dot`` with fp32 results, which Triton emits as
    Hopper ``wgmma``;
  * the padded / swizzled shared-memory K/V staging and the 3-stage
    cp.async pipeline (flash_attention.cu:91-95, 336-414) are Triton's
    ``num_stages`` ring of asynchronous K/V copies;
  * the causal reversed-Q launch order (flash_attention.cu:103-111) is kept:
    Q tiles are enumerated last-first, so the heaviest programs start first;
  * tiles and warps come from shape (ops/tuning.py), as the reference's four
    tiers did (flash_attention.cu:606-663).

Masks cost work only where they can bite: each program splits its KV range
into a mask-free middle and masked edges (the causal diagonal, the sliding
window's leading edge, a ragged last tile). Packed inputs narrow the KV range
of each Q tile to the tiles whose segment ids can match.

Numerics contract (SURVEY.md §5 "numerics policy"): fp16/bf16 I/O, fp32 score
and output accumulators, exp2-domain softmax with log2(e) folded into the
scale (flash_attention.cu:239), finite large-negative mask value rather than
-inf, and an l == 0 → output 0 guard (flash_attention.cu:502-503).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl

from flash_attention_tpu.ops.common import (
    LOG2E,
    M_FLOOR,
    MASK_VALUE,
    ceil_to,
    next_pow2,
    resolve_interpret,
    triton_params,
)
from flash_attention_tpu.ops.tuning import (
    BlockSizes,
    clamp_to_seq,
    select_block_sizes,
    select_bwd_block_sizes,
)


def _cdiv(a, b: int):
    """Ceil division of a non-negative traced int by a static int."""
    return lax.div(a + (b - 1), b)


def _kv_ranges(r0, *, block_q, block_kv, num_kv_blocks, kv_len, causal,
               window, seg_bounds=None):
    """KV tile ranges of the Q tile whose first row sits at KV position r0.

    Returns (lo, a, b, hi): tiles [lo, a) and [b, hi) need the mask, tiles
    [a, b) are fully visible to every row of the tile.
    """
    hi = num_kv_blocks
    full_hi = num_kv_blocks
    if causal:
        # Columns <= the last row's position; fully live while <= r0.
        hi = jnp.minimum(_cdiv(r0 + block_q, block_kv), num_kv_blocks)
        full_hi = lax.div(r0 + 1, block_kv)
    if kv_len % block_kv:
        full_hi = jnp.minimum(full_hi, kv_len // block_kv)
    lo = 0
    full_lo = 0
    if window is not None:
        lo = lax.div(jnp.maximum(r0 - window + 1, 0), block_kv)
        full_lo = _cdiv(jnp.maximum(r0 + block_q - window, 0), block_kv)
    if seg_bounds is not None:
        lo = jnp.maximum(lo, seg_bounds[0])
        hi = jnp.minimum(hi, seg_bounds[1])
    a = jnp.minimum(jnp.maximum(full_lo, lo), hi)
    b = jnp.maximum(a, jnp.minimum(full_hi, hi))
    return lo, a, b, hi


def tile_loop(ranges, body, carry, *, packed):
    """Run ``body(j, carry, masked)`` over the tiles of ``ranges`` = (lo, a,
    b, hi): masked edges [lo, a) and [b, hi) around a mask-free middle
    [a, b). Segment ids can mask any tile, so packed inputs take one masked
    loop over [lo, hi)."""
    lo, a, b, hi = ranges
    masked = functools.partial(body, masked=True)
    if packed:
        return lax.fori_loop(lo, hi, masked, carry)
    carry = lax.fori_loop(lo, a, masked, carry)
    carry = lax.fori_loop(a, b, functools.partial(body, masked=False), carry)
    return lax.fori_loop(b, hi, masked, carry)


def _logits(s, *, sm_scale, softcap):
    """Raw QKᵀ -> base-2 logits (and tanh for the softcap gradient)."""
    if softcap is None:
        return s * (sm_scale * LOG2E), None
    t = jnp.tanh(s * (sm_scale / softcap))
    return t * (softcap * LOG2E), t


def _visible(rows, cols, *, kv_len, kv_pad, causal, window, seg_q, seg_kv):
    ok = None

    def both(a, b):
        return b if a is None else jnp.logical_and(a, b)

    if kv_pad != kv_len:
        ok = both(ok, cols < kv_len)
    if causal:
        ok = both(ok, cols <= rows)
    if window is not None:
        ok = both(ok, cols > rows - window)
    if seg_q is not None:
        ok = both(ok, seg_q[:, None] == seg_kv[None, :])
    return ok


def _fwd_kernel(
    q_ref, k_ref, v_ref, *refs,
    sm_scale, causal, window, softcap, packed, save_residuals,
    q_len, kv_len, kv_pad, block_q, block_kv, num_q_blocks,
):
    refs = list(refs)
    segq_ref = segkv_ref = bounds_ref = None
    if packed:
        segq_ref, segkv_ref, bounds_ref = refs[:3]
        refs = refs[3:]
    o_ref = refs[0]
    lse_ref = refs[1] if save_residuals else None

    iq = pl.program_id(1)
    if causal:
        iq = num_q_blocks - 1 - iq  # heaviest tiles launch first
    r0 = iq * block_q + (kv_len - q_len)
    num_kv_blocks = kv_pad // block_kv
    q = q_ref[...]
    seg_q = segq_ref[...] if packed else None
    rows = r0 + jnp.arange(block_q, dtype=jnp.int32)[:, None]

    def body(j, carry, masked):
        acc, m, l = carry
        start = j * block_kv
        k = k_ref[pl.ds(start, block_kv), :]
        s, _ = _logits(pl.dot(q, k, trans_b=True), sm_scale=sm_scale,
                       softcap=softcap)
        if masked:
            cols = start + jnp.arange(block_kv, dtype=jnp.int32)[None, :]
            seg_kv = segkv_ref[pl.ds(start, block_kv)] if packed else None
            ok = _visible(rows, cols, kv_len=kv_len, kv_pad=kv_pad,
                          causal=causal, window=window, seg_q=seg_q,
                          seg_kv=seg_kv)
            if ok is not None:
                s = jnp.where(ok, s, MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        l = alpha * l + jnp.sum(p, axis=1)
        v = v_ref[pl.ds(start, block_kv), :]
        acc = acc * alpha[:, None] + pl.dot(p.astype(v.dtype), v)
        return acc, m_new, l

    ranges = _kv_ranges(
        r0, block_q=block_q, block_kv=block_kv, num_kv_blocks=num_kv_blocks,
        kv_len=kv_len, causal=causal, window=window,
        seg_bounds=(bounds_ref[0], bounds_ref[1]) if packed else None,
    )
    carry = (
        jnp.zeros((block_q, q.shape[-1]), jnp.float32),
        jnp.full((block_q,), M_FLOOR, jnp.float32),
        jnp.zeros((block_q,), jnp.float32),
    )
    acc, m, l = tile_loop(ranges, body, carry, packed=packed)

    empty = l == 0.0
    l_safe = jnp.where(empty, 1.0, l)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    if lse_ref is not None:
        lse_ref[...] = jnp.where(empty, -jnp.inf, m + jnp.log2(l_safe))


def pad_segments(segments, q_len, q_pad, kv_len, kv_pad):
    """Pad segment ids with distinct sentinels: padded rows and columns never
    match anything."""
    seg_q, seg_kv = segments
    seg_q = jnp.pad(seg_q.astype(jnp.int32), ((0, 0), (0, q_pad - q_len)),
                    constant_values=-1)
    seg_kv = jnp.pad(seg_kv.astype(jnp.int32), ((0, 0), (0, kv_pad - kv_len)),
                     constant_values=-2)
    return seg_q, seg_kv


def segment_block_bounds(seg_q, seg_kv, block_q, block_kv, q_len, kv_len):
    """Per-tile live ranges of packed inputs (ids padded to tile multiples;
    the first q_len / kv_len columns are real).

    Two tiles can share a segment only if the id ranges of their real rows
    intersect. Returns ([B, nq, 2] first/last-exclusive KV tile per Q tile,
    [B, nkv, 2] first/last-exclusive Q tile per KV tile). Exact for
    contiguous packing, and never excludes a live tile for arbitrary ids
    (everything between the first and last intersecting tile stays in range).
    """
    big = jnp.iinfo(jnp.int32).max

    def id_range(ids, n, block):
        real = jnp.arange(ids.shape[1]) < n
        lo = jnp.where(real, ids, big).reshape(ids.shape[0], -1, block)
        hi = jnp.where(real, ids, -big).reshape(ids.shape[0], -1, block)
        return lo.min(-1), hi.max(-1)

    q_lo, q_hi = id_range(seg_q, q_len, block_q)
    k_lo, k_hi = id_range(seg_kv, kv_len, block_kv)
    live = jnp.logical_and(
        q_lo[:, :, None] <= k_hi[:, None, :],
        k_lo[:, None, :] <= q_hi[:, :, None],
    )  # [B, nq, nkv]

    def bounds(x):
        n = x.shape[-1]
        any_live = jnp.any(x, axis=-1)
        first = jnp.argmax(x, axis=-1)
        last = n - jnp.argmax(x[..., ::-1], axis=-1)
        first = jnp.where(any_live, first, 0)
        last = jnp.where(any_live, last, 0)
        return jnp.stack([first, last], axis=-1).astype(jnp.int32)

    return bounds(live), bounds(jnp.swapaxes(live, 1, 2))


def _fwd_impl(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool,
    sm_scale: float,
    block_sizes: BlockSizes,
    save_residuals: bool,
    interpret: bool,
    window: int | None = None,
    softcap: float | None = None,
    segments=None,
):
    """Forward implementation; defaults already resolved by the caller.

    segments: optional (q_segment_ids [B, Sq], kv_segment_ids [B, Skv]) int32
    pair for packed sequences — scores are masked where ids differ.
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

    qq = q.reshape(batch * num_q_heads, q_len, head_dim)
    kk = k.reshape(batch * num_kv_heads, kv_len, head_dim)
    vv = v.reshape(batch * num_kv_heads, kv_len, head_dim)
    if q_pad != q_len or d_pad != head_dim:
        qq = jnp.pad(qq, ((0, 0), (0, q_pad - q_len), (0, d_pad - head_dim)))
    if kv_pad != kv_len or d_pad != head_dim:
        pads = ((0, 0), (0, kv_pad - kv_len), (0, d_pad - head_dim))
        kk = jnp.pad(kk, pads)
        vv = jnp.pad(vv, pads)

    def q_tile(i):
        return num_q_blocks - 1 - i if causal else i

    def kv_row(bh):
        return (bh // num_q_heads) * num_kv_heads + (bh % num_q_heads) // group

    in_specs = [
        pl.BlockSpec((None, block_q, d_pad), lambda bh, i: (bh, q_tile(i), 0)),
        pl.BlockSpec((None, kv_pad, d_pad), lambda bh, i: (kv_row(bh), 0, 0)),
        pl.BlockSpec((None, kv_pad, d_pad), lambda bh, i: (kv_row(bh), 0, 0)),
    ]
    inputs = [qq, kk, vv]
    packed = segments is not None
    if packed:
        seg_q, seg_kv = pad_segments(segments, q_len, q_pad, kv_len, kv_pad)
        q_bounds, _ = segment_block_bounds(
            seg_q, seg_kv, block_q, block_kv, q_len, kv_len
        )
        b_of = lambda bh: bh // num_q_heads  # noqa: E731
        in_specs += [
            pl.BlockSpec((None, block_q), lambda bh, i: (b_of(bh), q_tile(i))),
            pl.BlockSpec((None, kv_pad), lambda bh, i: (b_of(bh), 0)),
            pl.BlockSpec((None, None, 2),
                         lambda bh, i: (b_of(bh), q_tile(i), 0)),
        ]
        inputs += [seg_q, seg_kv, q_bounds]

    out_specs = [
        pl.BlockSpec((None, block_q, d_pad), lambda bh, i: (bh, q_tile(i), 0))
    ]
    out_shape = [
        jax.ShapeDtypeStruct((batch * num_q_heads, q_pad, d_pad), q.dtype)
    ]
    if save_residuals:
        out_specs.append(
            pl.BlockSpec((None, block_q), lambda bh, i: (bh, q_tile(i)))
        )
        out_shape.append(
            jax.ShapeDtypeStruct((batch * num_q_heads, q_pad), jnp.float32)
        )

    kernel = functools.partial(
        _fwd_kernel,
        sm_scale=sm_scale, causal=causal, window=window, softcap=softcap,
        packed=packed, save_residuals=save_residuals, q_len=q_len,
        kv_len=kv_len, kv_pad=kv_pad, block_q=block_q, block_kv=block_kv,
        num_q_blocks=num_q_blocks,
    )
    with jax.named_scope("flash_attention_fwd"):
        results = pl.pallas_call(
            kernel,
            grid=(batch * num_q_heads, num_q_blocks),
            in_specs=in_specs,
            out_specs=out_specs,
            out_shape=out_shape,
            compiler_params=triton_params(bs.num_warps, bs.num_stages),
            interpret=interpret,
            backend="triton",
            name="flash_attention_fwd",
        )(*inputs)

    out = results[0][:, :q_len, :head_dim].reshape(
        batch, num_q_heads, q_len, head_dim
    )
    if save_residuals:
        lse2 = results[1][:, :q_len].reshape(batch, num_q_heads, q_len)
        return out, lse2
    return out


# Custom VJP: the forward saves (q, k, v, out, lse2); the backward runs the
# Triton dq / dkv kernels (ops/attention_bwd.py). The reference has no
# backward at all (SURVEY.md §2) — this is new capability, same numerics
# contract.
@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7, 8, 9, 10))
def _fa(
    q, k, v, segments, causal, sm_scale, block_sizes, bwd_block_sizes,
    interpret, window, softcap,
):
    return _fwd_impl(
        q, k, v,
        causal=causal, sm_scale=sm_scale, block_sizes=block_sizes,
        save_residuals=False, interpret=interpret,
        window=window, softcap=softcap, segments=segments,
    )


def _fa_fwd(
    q, k, v, segments, causal, sm_scale, block_sizes, bwd_block_sizes,
    interpret, window, softcap,
):
    out, lse2 = _fwd_impl(
        q, k, v,
        causal=causal, sm_scale=sm_scale, block_sizes=block_sizes,
        save_residuals=True, interpret=interpret,
        window=window, softcap=softcap, segments=segments,
    )
    return out, (q, k, v, out, lse2, segments)


def _fa_bwd(
    causal, sm_scale, block_sizes, bwd_block_sizes, interpret, window,
    softcap, res, g,
):
    from flash_attention_tpu.ops.attention_bwd import flash_attention_bwd

    q, k, v, out, lse2, segments = res
    dq, dk, dv = flash_attention_bwd(
        q, k, v, out, lse2, g,
        causal=causal, sm_scale=sm_scale,
        block_sizes=bwd_block_sizes, interpret=interpret,
        window=window, softcap=softcap, segments=segments,
    )
    # Integer segment ids carry no gradient: float0 cotangents.
    dseg = jax.tree_util.tree_map(
        lambda x: np.zeros(x.shape, jax.dtypes.float0), segments
    )
    return dq, dk, dv, dseg


_fa.defvjp(_fa_fwd, _fa_bwd)


@functools.partial(
    jax.jit,
    static_argnames=(
        "causal",
        "sm_scale",
        "block_sizes",
        "bwd_block_sizes",
        "save_residuals",
        "interpret",
        "sliding_window",
        "logit_softcap",
    ),
)
def flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    block_sizes: BlockSizes | None = None,
    bwd_block_sizes: BlockSizes | None = None,
    save_residuals: bool = False,
    interpret: bool | None = None,
    sliding_window: int | None = None,
    logit_softcap: float | None = None,
    segment_ids=None,
):
    """Fused multi-head flash attention (differentiable).

    Args:
      q: [batch, q_heads, q_seq, head_dim].
      k, v: [batch, kv_heads, kv_seq, head_dim]; q_heads % kv_heads == 0 (GQA
        heads are broadcast zero-copy through the KV BlockSpec index map).
      causal: lower-triangular masking, aligned so the last query attends to
        the full KV sequence (standard self-attention when q_seq == kv_seq).
      sm_scale: softmax scale, default 1/sqrt(head_dim)
        (flash_attention.cu:612).
      block_sizes: override the shape-derived tile choice (ops/tuning.py).
      bwd_block_sizes: tiles for the backward kernels.
      save_residuals: also return the base-2 log-sum-exp [batch, q_heads,
        q_seq] — the (m, l) contract used by the split-KV / ring-attention
        merge (the reference's latent split-K epilogue, flash_attention.cu:
        460-496, folded into one value). This path is not differentiable.
      interpret: run the kernels in the Pallas interpreter (default: the
        process-wide setting of ops/common.py, off).
      segment_ids: packed-sequence ids — either one [batch, seq] int32 array
        (self-attention: used for both Q and KV) or a (q_ids [batch, q_seq],
        kv_ids [batch, kv_seq]) pair. Positions attend only within their own
        segment (scores masked where ids differ), composing with causal /
        sliding_window / logit_softcap; fully differentiable. The reference
        has no packing support — this serves packed pretraining batches
        (multiple documents per row without cross-contamination).

    Returns:
      [batch, q_heads, q_seq, head_dim] output, plus the LSE if requested.
    """
    batch, num_q_heads, q_len, head_dim = q.shape
    _, num_kv_heads, kv_len, _ = k.shape
    if num_q_heads % num_kv_heads:
        raise ValueError(f"q_heads={num_q_heads} % kv_heads={num_kv_heads} != 0")
    if k.shape != v.shape:
        raise ValueError(f"k/v shape mismatch: {k.shape} vs {v.shape}")
    if k.shape[0] != batch or k.shape[3] != head_dim:
        # A batch mismatch would otherwise index KV rows of another batch
        # element through the index map.
        raise ValueError(f"q/kv shape mismatch: {q.shape} vs {k.shape}")
    if causal and kv_len < q_len:
        raise ValueError("causal requires kv_seq >= q_seq")
    if sliding_window is not None:
        if not causal:
            raise ValueError("sliding_window requires causal=True")
        if sliding_window < 1:
            raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if logit_softcap is not None and logit_softcap <= 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    segments = None
    if segment_ids is not None:
        if isinstance(segment_ids, (tuple, list)):
            seg_q_ids, seg_kv_ids = segment_ids
        else:
            if q_len != kv_len:
                raise ValueError(
                    "single segment_ids array requires q_seq == kv_seq; pass "
                    "a (q_ids, kv_ids) pair for cross-length attention"
                )
            seg_q_ids = seg_kv_ids = segment_ids
        if seg_q_ids.shape != (batch, q_len):
            raise ValueError(
                f"q segment_ids shape {seg_q_ids.shape} != {(batch, q_len)}"
            )
        if seg_kv_ids.shape != (batch, kv_len):
            raise ValueError(
                f"kv segment_ids shape {seg_kv_ids.shape} != {(batch, kv_len)}"
            )
        segments = (seg_q_ids, seg_kv_ids)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(head_dim)
    interpret = resolve_interpret(interpret)
    if block_sizes is None:
        block_sizes = select_block_sizes(q_len, kv_seq=kv_len, head_dim=head_dim)
    if bwd_block_sizes is None:
        bwd_block_sizes = select_bwd_block_sizes(
            q_len, kv_seq=kv_len, head_dim=head_dim
        )

    if save_residuals:
        return _fwd_impl(
            q, k, v,
            causal=causal, sm_scale=sm_scale, block_sizes=block_sizes,
            save_residuals=True, interpret=interpret,
            window=sliding_window, softcap=logit_softcap, segments=segments,
        )
    return _fa(
        q, k, v, segments, causal, sm_scale, block_sizes, bwd_block_sizes,
        interpret, sliding_window, logit_softcap,
    )
