"""shard_map wrappers: head-/batch-parallel attention and cross-chip merges.

Replacements for the parallelism the reference lacks (SURVEY.md §2
inventory): data parallelism = batch axis sharding, tensor parallelism =
attention-head sharding (zero communication during attention — each chip runs
the same kernel on its head shard), and context parallelism = KV-shard
partial attention combined with the split-K merge math (flash_attention.cu:
584-592) expressed as pmax/psum collectives over the mesh.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from flash_attention_tpu.ops.decode import decode_attention
from flash_attention_tpu.ops.flash_attention import flash_attention


def make_sharded_flash_attention(
    mesh: Mesh,
    *,
    causal: bool = False,
    sm_scale: float | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
    block_sizes=None,
):
    """Head- and batch-sharded forward attention.

    Q/K/V/O: [B, H, S, D] with B sharded over `data_axis` and H over
    `model_axis`. GQA: KV heads shard over the same model axis (co-location —
    q heads land with their KV head as long as model_axis size divides
    num_kv_heads). No collectives run during attention.
    """
    spec = P(data_axis, model_axis, None, None)

    def _local(q, k, v):
        return flash_attention(
            q, k, v, causal=causal, sm_scale=sm_scale, block_sizes=block_sizes
        )

    fn = jax.shard_map(
        _local, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_decode_attention(
    mesh: Mesh,
    *,
    sm_scale: float | None = None,
    block_kv: int | None = None,
    data_axis: str = "data",
    model_axis: str = "model",
):
    """Decode attention with the KV cache sharded over batch x heads.

    q: [B, Hq, D]; caches: [B, Hkv, S, D] (plain or QuantizedTensor);
    lengths: [B] (replicated over the model axis, sharded over data).
    Zero communication: each chip decodes its (batch-shard, head-shard) of
    the cache. The all-reduce, if any, belongs to the caller's output
    projection (models/attention.py).
    """
    q_spec = P(data_axis, model_axis, None)
    kv_spec = P(data_axis, model_axis, None, None)
    len_spec = P(data_axis)

    def _local(q, k, v, lengths):
        return decode_attention(
            q, k, v, lengths, sm_scale=sm_scale, block_kv=block_kv
        )

    fn = jax.shard_map(
        _local,
        mesh=mesh,
        in_specs=(q_spec, kv_spec, kv_spec, len_spec),
        out_specs=q_spec,
        check_vma=False,
    )
    return jax.jit(fn)


def cross_chip_merge(o_local, lse_local, axis_name: str):
    """Combine per-chip partial attention over `axis_name`.

    The reference's split-K merge (flash_attention.cu:575-597) as mesh
    collectives: global max via pmax, exp2-domain weights, psum of weighted
    outputs and weights. Call inside shard_map after a per-shard
    flash_attention(..., save_residuals=True) over KV shards.
    """
    m = jax.lax.pmax(lse_local, axis_name)
    m_safe = jnp.where(jnp.isneginf(m), 0.0, m)
    w = jnp.exp2(lse_local - m_safe)  # -inf lse -> weight 0
    denom = jax.lax.psum(w, axis_name)
    o_sum = jax.lax.psum(
        w[..., None].astype(jnp.float32) * o_local.astype(jnp.float32), axis_name
    )
    denom_safe = jnp.where(denom == 0.0, 1.0, denom)
    o = o_sum / denom_safe[..., None]
    lse = jnp.where(denom == 0.0, -jnp.inf, m + jnp.log2(denom_safe))
    return o.astype(o_local.dtype), lse


def make_context_parallel_attention(
    mesh: Mesh,
    *,
    sm_scale: float | None = None,
    data_axis: str = "data",
    context_axis: str = "context",
    model_axis: str = "model",
    block_sizes=None,
):
    """Sequence-parallel (non-causal) attention: KV sharded over the context
    axis, Q replicated along it; each chip computes a partial against its KV
    shard and results merge with :func:`cross_chip_merge`. Batch shards over
    `data_axis` like the sibling factories (on a data x model x context mesh
    each data row would otherwise redo the full batch — pure waste).

    For causal self-attention use ring attention (parallel/ring.py), which
    both balances the triangle and overlaps KV movement with compute.
    """
    q_spec = P(data_axis, model_axis, None, None)
    kv_spec = P(data_axis, model_axis, context_axis, None)

    def _local(q, k, v):
        o, lse = flash_attention(
            q, k, v, causal=False, sm_scale=sm_scale,
            block_sizes=block_sizes, save_residuals=True,
        )
        o, _ = cross_chip_merge(o, lse, context_axis)
        return o

    fn = jax.shard_map(
        _local, mesh=mesh, in_specs=(q_spec, kv_spec, kv_spec),
        out_specs=q_spec, check_vma=False,
    )
    return jax.jit(fn)
