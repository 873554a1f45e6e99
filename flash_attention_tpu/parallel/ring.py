"""Ring attention: sequence-parallel attention with KV rotation between devices.

The beyond-chip generalization of the reference's intra-kernel blockwise KV
streaming (the hot loop at flash_attention.cu:417-453): instead of streaming
KV tiles HBM→smem within one GPU, KV *shards* rotate device→device around
the mesh's context axis via ``jax.lax.ppermute`` (point-to-point, which XLA
hands to NCCL over NVLink),
and the per-step partial results combine with the same (m, l, O) merge math as
the reference's split-K merge kernel (flash_attention.cu:575-597) — here the
base-2 LSE form in ops/merge.py.

Causal handling decomposes each ring step by block position, mirroring the
kernel's own three-tier masking (skip / diagonal / full):
  * step 0: the local diagonal chunk → causal kernel
  * step s>0 from an earlier chunk  → full (non-causal) kernel
  * step s>0 from a later chunk     → fully masked → skipped via lax.cond
Communication is point-to-point and overlaps with compute under XLA's
latency-hiding scheduler (the ppermute for step s+1 is independent of step
s's attention).

Causal load balance — the ZIGZAG layout (``zigzag=True``): with contiguous
sharding, shard i computes i+1 live steps, so shard 0 idles through n-1
lax.cond skips while shard n-1 computes every step (~2x wall-clock waste at
scale). Zigzag placement gives shard i the global sequence chunks
{i, 2n-1-i} (2n chunks of S/(2n) each). Per ring step s>0, exactly TWO of
the four (q-half, kv-half) pairs are live on EVERY shard — the late Q half
always attends the early KV half, and exactly one of (early-q, early-kv) /
(late-q, late-kv) is live depending on the step's direction — so every
shard computes the same 2·(S/2n)² scores per step and the ring is perfectly
balanced: per-shard work = S²/(2n), the causal optimum. This is the
cross-chip equivalent of the reference's grid-swap/reversed-Q causal
balancing (flash_attention.cu:103-111); merge math (merge_two) is unchanged.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.merge import merge_two
from flash_attention_tpu.ops.tuning import select_bwd_block_sizes


def zigzag_indices(seq_len: int, n: int):
    """Global→zigzag gather indices: shard i holds chunks {i, 2n-1-i}.

    Returns an int32 [seq_len] index array ``idx`` such that
    ``x[..., idx, ...]`` lays the sequence out in zigzag shard order
    (shard-major: shard 0's [chunk 0 | chunk 2n-1], shard 1's
    [chunk 1 | chunk 2n-2], ...). seq_len must divide evenly into 2n chunks.
    """
    import numpy as np

    if seq_len % (2 * n):
        raise ValueError(f"seq_len={seq_len} not divisible by 2n={2 * n}")
    c = seq_len // (2 * n)
    chunks = np.arange(seq_len, dtype=np.int32).reshape(2 * n, c)
    order = []
    for i in range(n):
        order.append(chunks[i])
        order.append(chunks[2 * n - 1 - i])
    return jnp.asarray(np.concatenate(order))


def inverse_permutation(idx: jax.Array) -> jax.Array:
    """Indices that undo a gather by ``idx`` (zigzag → global order)."""
    return jnp.argsort(idx)


def zigzag_data_layout(seq_len: int, n_ctx: int):
    """One-time data-loader permutation for zigzag ring-attention training.

    Returns ``(idx, positions)``: gather indices laying any ``[..., S, ...]``
    batch out in zigzag shard order (``tokens[:, idx]``), and the absolute
    RoPE positions of the permuted tokens (identical values, int32 — named
    separately because they play different roles).

    Production pattern (see tests/test_parallel.py::test_zigzag_training_loop):
    permute tokens AND targets once per batch at the data loader, feed
    ``positions`` to RoPE so angles travel with the tokens, keep every
    activation permanently in zigzag layout, and call
    :func:`ring_flash_attention` with ``zigzag=True`` directly. Per-token
    losses are order-invariant under a shared permutation, so nothing is
    ever permuted back — unlike :func:`make_ring_attention`'s convenience
    wrapper, which pays one all-to-all each way per call.
    """
    idx = zigzag_indices(seq_len, n_ctx)
    return idx, idx.astype(jnp.int32)


def ring_flash_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    causal: bool = False,
    sm_scale: float | None = None,
    block_sizes=None,
    bwd_block_sizes=None,
    zigzag: bool = False,
):
    """Per-shard ring attention body (call inside shard_map). Differentiable.

    Args:
      q, k, v: the local shards [B, H, S/N, D] — the sequence axis is sharded
        over `axis_name` in ring order (shard i holds positions
        [i*S/N, (i+1)*S/N)), or, with ``zigzag=True``, in zigzag order
        (shard i holds global chunks {i, 2n-1-i} of size S/2N, early chunk
        first — see :func:`zigzag_indices`).
      axis_name: the mesh context axis forming the ring.
      zigzag: balanced causal layout (requires causal=True).

    Returns:
      [B, H, S/N, D] output for the local Q shard (in the same layout).

    Differentiation runs a SECOND KV rotation (see :func:`_ring_bwd`):
    fp32 dK/dV accumulators travel with each KV chunk around the ring, each
    (Q-shard, KV-chunk) pair reuses the fused backward kernels
    (ops/attention_bwd.py) with the ring-combined global LSE — which makes
    the per-pair recomputed P the *global* softmax probabilities, so partial
    gradients sum exactly — and one final ppermute returns dK/dV to their
    owner shards. This differentiates the reference's split-K merge contract
    (flash_attention.cu:575-597): the forward merge is a log-sum-exp over
    partials, whose VJP is precisely "backprop each partial against the
    merged LSE".
    """
    if zigzag and not causal:
        raise ValueError("zigzag layout only applies to causal attention")
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _ring(q, k, v, axis_name, causal, sm_scale, block_sizes,
                 bwd_block_sizes, zigzag)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7, 8))
def _ring(q, k, v, axis_name, causal, sm_scale, block_sizes, bwd_block_sizes,
          zigzag):
    o, _ = _ring_fwd_impl(
        q, k, v, axis_name=axis_name, causal=causal, sm_scale=sm_scale,
        block_sizes=block_sizes, zigzag=zigzag,
    )
    return o


def _ring_vjp_fwd(q, k, v, axis_name, causal, sm_scale, block_sizes,
                  bwd_block_sizes, zigzag):
    o, lse = _ring_fwd_impl(
        q, k, v, axis_name=axis_name, causal=causal, sm_scale=sm_scale,
        block_sizes=block_sizes, zigzag=zigzag,
    )
    return o, (q, k, v, o, lse)


def _ring_vjp_bwd(axis_name, causal, sm_scale, block_sizes, bwd_block_sizes,
                  zigzag, res, g):
    q, k, v, o, lse = res
    return _ring_bwd(
        q, k, v, o, lse, g, axis_name=axis_name, causal=causal,
        sm_scale=sm_scale, bwd_block_sizes=bwd_block_sizes, zigzag=zigzag,
    )


_ring.defvjp(_ring_vjp_fwd, _ring_vjp_bwd)


def _ring_fwd_impl(
    q, k, v, *, axis_name, causal, sm_scale, block_sizes, zigzag
):
    """Forward ring; returns (o, ring-combined base-2 LSE)."""
    if zigzag:
        return _ring_zigzag(
            q, k, v, axis_name=axis_name, sm_scale=sm_scale,
            block_sizes=block_sizes,
        )
    n = jax.lax.axis_size(axis_name)
    my_idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]

    def attend(kv_chunk, step_causal):
        kc, vc = kv_chunk
        return flash_attention(
            q, kc, vc,
            causal=step_causal, sm_scale=sm_scale,
            block_sizes=block_sizes, save_residuals=True,
        )

    # Step 0: local (diagonal) chunk.
    o, lse = attend((k, v), causal)
    o = o.astype(jnp.float32)

    k_blk, v_blk = k, v
    for step in range(1, n):
        # Rotate first; XLA overlaps the ppermute with the previous/next
        # attention kernel since they have no data dependency.
        k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
        v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
        if causal:
            # The chunk now held came from shard (my_idx - step) mod n; it is
            # visible iff it holds earlier positions: my_idx >= step.
            visible = my_idx >= step

            def compute(kv):
                return attend(kv, False)

            def skip(kv):
                return (
                    jnp.zeros_like(o, dtype=q.dtype),
                    jnp.full_like(lse, -jnp.inf),
                )

            o_s, lse_s = jax.lax.cond(visible, compute, skip, (k_blk, v_blk))
        else:
            o_s, lse_s = attend((k_blk, v_blk), False)
        o, lse = merge_two(o, lse, o_s, lse_s)

    return o.astype(q.dtype), lse


def _pair_bwd(q_c, k_c, v_c, o_c, lse_c, do_c, *, causal, sm_scale,
              bwd_block_sizes=None):
    """(dq, dk, dv) of one (Q shard, KV chunk) pair against the GLOBAL lse.

    With the ring-combined lse2, exp2(s·scale·log2e − lse2) is the global
    softmax probability of that pair's scores, and delta = rowsum(dO ∘ O)
    uses the final merged output — so each pair's fused-kernel gradients are
    exact partial sums of the full-attention gradients.
    """
    from flash_attention_tpu.ops.attention_bwd import flash_attention_bwd
    from flash_attention_tpu.ops.common import resolve_interpret

    bs = bwd_block_sizes or select_bwd_block_sizes(
        q_c.shape[2], kv_seq=k_c.shape[2], head_dim=q_c.shape[3]
    )
    return flash_attention_bwd(
        q_c, k_c, v_c, o_c, lse_c, do_c,
        causal=causal, sm_scale=sm_scale, block_sizes=bs,
        interpret=resolve_interpret(None),
    )


def _ring_bwd(q, k, v, o, lse, do, *, axis_name, causal, sm_scale,
              bwd_block_sizes, zigzag):
    """Second rotation: dK/dV accumulators travel with their KV chunk."""
    n = jax.lax.axis_size(axis_name)
    my_idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    do = do.astype(q.dtype)

    if zigzag:
        return _ring_bwd_zigzag(
            q, k, v, o, lse, do, axis_name=axis_name, sm_scale=sm_scale,
            bwd_block_sizes=bwd_block_sizes,
        )

    # Step 0: local chunk (the only causal pair).
    dq_0, dk_0, dv_0 = _pair_bwd(
        q, k, v, o, lse, do, causal=causal, sm_scale=sm_scale,
        bwd_block_sizes=bwd_block_sizes,
    )
    dq = dq_0.astype(jnp.float32)
    dk_c = dk_0.astype(jnp.float32)
    dv_c = dv_0.astype(jnp.float32)

    k_blk, v_blk = k, v
    for step in range(1, n):
        k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
        v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
        dk_c = jax.lax.ppermute(dk_c, axis_name, perm)
        dv_c = jax.lax.ppermute(dv_c, axis_name, perm)
        if causal:
            visible = my_idx >= step

            def compute(kv):
                kc, vc = kv
                return _pair_bwd(
                    q, kc, vc, o, lse, do, causal=False, sm_scale=sm_scale,
                    bwd_block_sizes=bwd_block_sizes,
                )

            def skip(kv):
                return (
                    jnp.zeros_like(q), jnp.zeros_like(k), jnp.zeros_like(v)
                )

            dq_s, dk_s, dv_s = jax.lax.cond(
                visible, compute, skip, (k_blk, v_blk)
            )
        else:
            dq_s, dk_s, dv_s = _pair_bwd(
                q, k_blk, v_blk, o, lse, do, causal=False, sm_scale=sm_scale,
                bwd_block_sizes=bwd_block_sizes,
            )
        dq = dq + dq_s.astype(jnp.float32)
        dk_c = dk_c + dk_s.astype(jnp.float32)
        dv_c = dv_c + dv_s.astype(jnp.float32)

    # The accumulators sit one shard behind their owner after n-1 rotations;
    # a final hop returns chunk j's dK/dV to shard j.
    dk_c = jax.lax.ppermute(dk_c, axis_name, perm)
    dv_c = jax.lax.ppermute(dv_c, axis_name, perm)
    return dq.astype(q.dtype), dk_c.astype(k.dtype), dv_c.astype(v.dtype)


def _ring_bwd_zigzag(q, k, v, o, lse, do, *, axis_name, sm_scale,
                     bwd_block_sizes):
    """Backward over the zigzag layout: same liveness decomposition as the
    forward (_ring_zigzag), per-pair fused backward against the global LSE,
    dK/dV halves accumulated in the traveling carry."""
    n = jax.lax.axis_size(axis_name)
    my_idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    c = q.shape[2] // 2
    q_e, q_l = q[:, :, :c], q[:, :, c:]
    o_l = o[:, :, c:]
    do_e, do_l = do[:, :, :c], do[:, :, c:]
    o_e = o[:, :, :c]
    lse_e, lse_l = lse[:, :, :c], lse[:, :, c:]

    # Step 0: local causal over the in-order [early | late] concat.
    dq_0, dk_0, dv_0 = _pair_bwd(
        q, k, v, o, lse, do, causal=True, sm_scale=sm_scale,
        bwd_block_sizes=bwd_block_sizes,
    )
    dq = dq_0.astype(jnp.float32)
    dk_c = dk_0.astype(jnp.float32)
    dv_c = dv_0.astype(jnp.float32)

    k_blk, v_blk = k, v
    for step in range(1, n):
        k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
        v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
        dk_c = jax.lax.ppermute(dk_c, axis_name, perm)
        dv_c = jax.lax.ppermute(dv_c, axis_name, perm)
        k_e, k_l = k_blk[:, :, :c], k_blk[:, :, c:]
        v_e, v_l = v_blk[:, :, :c], v_blk[:, :, c:]
        j = (my_idx - step) % n

        # Always live: late Q against the arriving early KV chunk.
        dq_a, dk_a, dv_a = _pair_bwd(
            q_l, k_e, v_e, o_l, lse_l, do_l, causal=False, sm_scale=sm_scale,
            bwd_block_sizes=bwd_block_sizes,
        )
        dq = dq.at[:, :, c:].add(dq_a.astype(jnp.float32))
        dk_c = dk_c.at[:, :, :c].add(dk_a.astype(jnp.float32))
        dv_c = dv_c.at[:, :, :c].add(dv_a.astype(jnp.float32))

        # Direction-dependent half (see _ring_zigzag).
        early_live = j < my_idx

        def early_case(_):
            return _pair_bwd(
                q_e, k_e, v_e, o_e, lse_e, do_e,
                causal=False, sm_scale=sm_scale,
                bwd_block_sizes=bwd_block_sizes,
            )

        def late_case(_):
            return _pair_bwd(
                q_l, k_l, v_l, o_l, lse_l, do_l,
                causal=False, sm_scale=sm_scale,
                bwd_block_sizes=bwd_block_sizes,
            )

        dq_c2, dk_c2, dv_c2 = jax.lax.cond(early_live, early_case, late_case, None)
        dq_c2 = dq_c2.astype(jnp.float32)
        dk_c2 = dk_c2.astype(jnp.float32)
        dv_c2 = dv_c2.astype(jnp.float32)
        zero = jnp.zeros_like(dq_c2)
        # early_live: gradients belong to (q_early, kv_early); otherwise to
        # (q_late, kv_late).
        dq = dq.at[:, :, :c].add(jnp.where(early_live, dq_c2, zero))
        dq = dq.at[:, :, c:].add(jnp.where(early_live, zero, dq_c2))
        dk_c = dk_c.at[:, :, :c].add(jnp.where(early_live, dk_c2, zero))
        dk_c = dk_c.at[:, :, c:].add(jnp.where(early_live, zero, dk_c2))
        dv_c = dv_c.at[:, :, :c].add(jnp.where(early_live, dv_c2, zero))
        dv_c = dv_c.at[:, :, c:].add(jnp.where(early_live, zero, dv_c2))

    dk_c = jax.lax.ppermute(dk_c, axis_name, perm)
    dv_c = jax.lax.ppermute(dv_c, axis_name, perm)
    return dq.astype(q.dtype), dk_c.astype(k.dtype), dv_c.astype(v.dtype)


def _ring_zigzag(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    axis_name: str,
    sm_scale: float | None,
    block_sizes,
):
    """Balanced causal ring body over the zigzag layout (see module doc).

    The local shard holds [early | late] = global chunks (i, 2n-1-i), each of
    C rows. Per step s the KV from shard j = (i-s) mod n arrives; liveness:
      * q_late × kv_early: ALWAYS fully live (kv_early chunk j < n <= late q)
      * q_early × kv_early (chunk j vs i): live iff j < i (full)
      * q_late × kv_late (chunk 2n-1-j vs 2n-1-i): live iff j > i (full)
      * q_early × kv_late: never (kv chunk 2n-1-j >= n > i)
    Step 0 (j == i) is plain causal attention over the local [early|late]
    concatenation (in-order global positions, so the triangular mask is
    exact). For s > 0 exactly one of the two conditionals fires — same
    compute on every shard, every step.
    """
    n = jax.lax.axis_size(axis_name)
    my_idx = jax.lax.axis_index(axis_name)
    perm = [(i, (i + 1) % n) for i in range(n)]
    c = q.shape[2] // 2
    q_early, q_late = q[:, :, :c], q[:, :, c:]

    def attend(qc, kc, vc, step_causal):
        return flash_attention(
            qc, kc, vc,
            causal=step_causal, sm_scale=sm_scale,
            block_sizes=block_sizes, save_residuals=True,
        )

    # Step 0: local causal over the in-order [early | late] concat.
    o0, lse0 = attend(q, k, v, True)
    o_early = o0[:, :, :c].astype(jnp.float32)
    o_late = o0[:, :, c:].astype(jnp.float32)
    lse_early, lse_late = lse0[:, :, :c], lse0[:, :, c:]

    k_blk, v_blk = k, v
    for step in range(1, n):
        k_blk = jax.lax.ppermute(k_blk, axis_name, perm)
        v_blk = jax.lax.ppermute(v_blk, axis_name, perm)
        k_e, k_l = k_blk[:, :, :c], k_blk[:, :, c:]
        v_e, v_l = v_blk[:, :, :c], v_blk[:, :, c:]
        j = (my_idx - step) % n

        # Always live: late Q against the arriving early KV chunk.
        o_a, lse_a = attend(q_late, k_e, v_e, False)
        o_late, lse_late = merge_two(o_late, lse_late, o_a, lse_a)

        # Direction-dependent half: early-q×early-kv when j < i, else
        # late-q×late-kv. Both branches cost one CxC attention (balanced).
        early_live = j < my_idx

        def early_case(_):
            return attend(q_early, k_e, v_e, False)

        def late_case(_):
            return attend(q_late, k_l, v_l, False)

        o_c, lse_c = jax.lax.cond(early_live, early_case, late_case, None)

        neutral_o = jnp.zeros_like(o_c)
        neutral_lse = jnp.full_like(lse_c, -jnp.inf)
        o_early, lse_early = merge_two(
            o_early, lse_early,
            jnp.where(early_live, o_c, neutral_o),
            jnp.where(early_live, lse_c, neutral_lse),
        )
        o_late, lse_late = merge_two(
            o_late, lse_late,
            jnp.where(early_live, neutral_o, o_c),
            jnp.where(early_live, neutral_lse, lse_c),
        )

    return (
        jnp.concatenate([o_early, o_late], axis=2).astype(q.dtype),
        jnp.concatenate([lse_early, lse_late], axis=2),
    )


def make_ring_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    context_axis: str = "context",
    model_axis: str = "model",
    data_axis: str = "data",
    block_sizes=None,
    bwd_block_sizes=None,
    zigzag: bool = False,
):
    """jit-wrapped ring attention over [B, H, S, D] with S sharded on the
    context axis, H on the model axis, B on the data axis.

    With ``zigzag=True`` (causal only) the wrapper gathers inputs into the
    balanced zigzag layout and scatters the output back to global order, so
    callers see ordinary in-order sequences. Production training loops should
    instead keep activations permanently in zigzag layout (permute once at
    the data loader) and call :func:`ring_flash_attention` directly — the
    wrapper's per-call permutation costs one all-to-all each way.
    """
    spec = P(data_axis, model_axis, context_axis, None)
    n_ctx = mesh.shape[context_axis]

    body = functools.partial(
        ring_flash_attention,
        axis_name=context_axis,
        causal=causal,
        sm_scale=sm_scale,
        block_sizes=block_sizes,
        bwd_block_sizes=bwd_block_sizes,
        zigzag=zigzag,
    )

    def _local(q, k, v):
        return body(q, k, v)

    fn = jax.shard_map(
        _local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )

    if not zigzag:
        return jax.jit(fn)

    def with_permute(q, k, v):
        idx = zigzag_indices(q.shape[2], n_ctx)
        inv = inverse_permutation(idx)
        out = fn(q[:, :, idx], k[:, :, idx], v[:, :, idx])
        return out[:, :, inv]

    return jax.jit(with_permute)
