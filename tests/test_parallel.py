"""Multi-chip sharding paths on the virtual 8-device CPU mesh.

Validates: head/batch-sharded attention, context-parallel merge, ring
attention (causal + non-causal), sharded decode — all vs. the fp32 oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu.parallel.mesh import auto_mesh, make_mesh
from flash_attention_tpu.parallel.ring import make_ring_attention
from flash_attention_tpu.parallel.sharding import (
    make_context_parallel_attention,
    make_sharded_decode_attention,
    make_sharded_flash_attention,
)
from flash_attention_tpu.utils.testing import assert_close, make_qkv

BS = BlockSizes(block_q=128, block_kv=128)


def test_mesh_helpers():
    mesh = make_mesh(data=2, model=4)
    assert mesh.shape == {"data": 2, "model": 4, "context": 1}
    mesh = auto_mesh(8, num_kv_heads=4)
    assert mesh.shape["model"] == 4 and mesh.shape["data"] == 2


@pytest.mark.parametrize("causal", [False, True])
def test_head_and_batch_sharded_attention(causal):
    mesh = make_mesh(data=2, model=4)
    q, k, v = make_qkv(51, 2, 8, 256, 128)
    fn = make_sharded_flash_attention(mesh, causal=causal, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"dp2 x tp4 causal={causal}")


def test_head_sharded_gqa_colocation():
    """8 q heads / 4 kv heads over model=4: one KV head per chip, no comms."""
    mesh = make_mesh(data=1, model=4)
    q, k, v = make_qkv(52, 1, 8, 256, 128, num_kv_heads=4)
    fn = make_sharded_flash_attention(mesh, causal=True, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="gqa tp4")


def test_context_parallel_noncausal():
    mesh = make_mesh(data=1, model=2, context=4)
    q, k, v = make_qkv(53, 1, 2, 512, 128)
    fn = make_context_parallel_attention(mesh, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v)
    assert_close(got, want, msg="context-parallel merge")


def test_context_parallel_batch_sharded():
    """Batch must shard over the data axis (not replicate): on a full
    data x model x context mesh the result is still exact."""
    mesh = make_mesh(data=2, model=2, context=2)
    q, k, v = make_qkv(56, 2, 2, 512, 128)
    fn = make_context_parallel_attention(mesh, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v)
    assert_close(got, want, msg="context-parallel dp2")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention(causal):
    mesh = make_mesh(data=1, model=2, context=4)
    q, k, v = make_qkv(54, 1, 2, 512, 128)
    fn = make_ring_attention(mesh, causal=causal, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"ring causal={causal}")


def test_ring_attention_full_context_axis():
    mesh = make_mesh(data=1, model=1, context=8)
    q, k, v = make_qkv(55, 1, 2, 1024, 128)
    fn = make_ring_attention(mesh, causal=True, block_sizes=BS)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="ring ctx=8 causal")


def test_ring_attention_zigzag():
    """Balanced causal ring: zigzag layout matches the oracle exactly."""
    mesh = make_mesh(data=1, model=2, context=4)
    q, k, v = make_qkv(57, 1, 2, 512, 128)
    fn = make_ring_attention(mesh, causal=True, block_sizes=BS, zigzag=True)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="zigzag ring causal")


def test_ring_attention_zigzag_full_axis():
    mesh = make_mesh(data=1, model=1, context=8)
    q, k, v = make_qkv(58, 1, 2, 2048, 128)
    fn = make_ring_attention(mesh, causal=True, block_sizes=BS, zigzag=True)
    got = fn(q, k, v)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="zigzag ring ctx=8")


def test_zigzag_indices_roundtrip():
    from flash_attention_tpu.parallel.ring import (
        inverse_permutation,
        zigzag_indices,
    )

    idx = zigzag_indices(32, 4)
    # Shard 0 holds chunks {0, 7}, shard 1 {1, 6}, ...
    np.testing.assert_array_equal(
        np.asarray(idx[:8]), np.r_[0:4, 28:32]
    )
    inv = inverse_permutation(idx)
    np.testing.assert_array_equal(np.asarray(idx[inv]), np.arange(32))


def test_sharded_decode():
    mesh = make_mesh(data=2, model=4)
    q, k, v = make_qkv(56, 2, 8, 1, 128, kv_seq=256)
    q = q[:, :, 0, :]
    lengths = jnp.array([256, 130], jnp.int32)
    fn = make_sharded_decode_attention(mesh, block_kv=128)
    got = fn(q, k, v, lengths)
    want = reference_attention(q[:, :, None, :], k, v, kv_length=lengths)[:, :, 0, :]
    assert_close(got, want, msg="sharded decode dp2 x tp4")


@pytest.mark.parametrize("zigzag", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_grad(causal, zigzag):
    """Differentiable ring: the custom VJP's second KV rotation (per-pair
    fused backward against the ring-combined global LSE + traveling dK/dV
    accumulators) must match jax.grad of the fp32 oracle."""
    if zigzag and not causal:
        pytest.skip("zigzag is causal-only")
    mesh = make_mesh(data=1, model=1, context=4)
    q, k, v = make_qkv(61, 1, 2, 512, 128)
    fn = make_ring_attention(
        mesh, causal=causal, zigzag=zigzag, block_sizes=BS
    )
    w = jax.random.normal(jax.random.key(3), q.shape)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    def loss_ref(q, k, v):
        return jnp.sum(
            reference_attention(q, k, v, causal=causal).astype(jnp.float32) * w
        )

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, wnt, name in zip(got, want, "qkv"):
        assert_close(g, wnt, msg=f"ring grad d{name} zigzag={zigzag}")


def test_zigzag_training_loop():
    """The PRODUCTION zigzag pattern: permute tokens/targets ONCE at the data
    loader (zigzag_data_layout), keep every activation permanently in zigzag
    layout, feed the permuted positions to RoPE so angles travel with their
    tokens, and differentiate straight through the shard_mapped
    ring_flash_attention(zigzag=True) — no per-step all-to-all anywhere.
    Two SGD steps must track the in-order dense-attention model exactly."""
    import functools

    from flash_attention_tpu.models.rope import apply_rope
    from flash_attention_tpu.parallel.ring import (
        ring_flash_attention,
        zigzag_data_layout,
    )
    from jax.sharding import PartitionSpec as P

    B, H, S, D, V = 2, 2, 512, 128, 64
    mesh = make_mesh(data=1, model=2, context=4)
    spec = P(None, "model", "context", None)
    ring = jax.shard_map(
        functools.partial(
            ring_flash_attention, axis_name="context", causal=True,
            zigzag=True, block_sizes=BS,
        ),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False,
    )

    key = jax.random.key(7)
    ks = jax.random.split(key, 6)
    params = {
        "emb": jax.random.normal(ks[0], (V, H * D), jnp.float32) * 0.1,
        "wq": jax.random.normal(ks[1], (H * D, H * D), jnp.float32) * 0.05,
        "wk": jax.random.normal(ks[2], (H * D, H * D), jnp.float32) * 0.05,
        "wv": jax.random.normal(ks[3], (H * D, H * D), jnp.float32) * 0.05,
        "wo": jax.random.normal(ks[4], (H * D, H * D), jnp.float32) * 0.05,
    }
    tokens = jax.random.randint(ks[5], (B, S), 0, V)
    targets = jnp.roll(tokens, -1, axis=1)

    def make_loss(attn):
        def loss(params, tokens, targets, positions):
            x = params["emb"][tokens]  # [B, S, HD]

            def heads(w):
                return (x @ w).reshape(B, S, H, D).transpose(0, 2, 1, 3)

            pos = positions[:, None, :]  # [B, 1, S] broadcast over heads
            q = apply_rope(heads(params["wq"]), pos)
            k = apply_rope(heads(params["wk"]), pos)
            o = attn(q, k, heads(params["wv"]))  # [B, H, S, D]
            o = o.transpose(0, 2, 1, 3).reshape(B, S, H * D) @ params["wo"]
            logits = o @ params["emb"].T
            logp = jax.nn.log_softmax(logits.astype(jnp.float32))
            nll = -jnp.take_along_axis(logp, targets[..., None], -1)
            return jnp.mean(nll)  # order-invariant under a shared permutation

        return jax.jit(jax.value_and_grad(loss))

    step_zig = make_loss(ring)
    step_ref = make_loss(
        lambda q, k, v: reference_attention(q, k, v, causal=True)
    )

    # ---- the one-time data-loader permutation ----
    idx, positions = zigzag_data_layout(S, n_ctx=4)
    tok_z, tgt_z = tokens[:, idx], targets[:, idx]
    pos_z = jnp.broadcast_to(positions[None, :], (B, S))
    pos_ref = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None, :], (B, S))

    p_zig = params
    p_ref = params
    lr = 0.5
    for step in range(2):
        lz, gz = step_zig(p_zig, tok_z, tgt_z, pos_z)
        lr_, gr = step_ref(p_ref, tokens, targets, pos_ref)
        np.testing.assert_allclose(
            float(lz), float(lr_), rtol=2e-4,
            err_msg=f"zigzag training loss diverged at step {step}",
        )
        p_zig = jax.tree_util.tree_map(lambda p, g: p - lr * g, p_zig, gz)
        p_ref = jax.tree_util.tree_map(lambda p, g: p - lr * g, p_ref, gr)

    for name in params:
        np.testing.assert_allclose(
            np.asarray(p_zig[name]), np.asarray(p_ref[name]),
            atol=5e-4, rtol=1e-3, err_msg=f"param {name} after 2 SGD steps",
        )


def test_ring_grad_honors_bwd_block_sizes():
    """bwd_block_sizes must reach the per-pair backward (a caller
    whose default backward tiles do not fit relies on this override)."""
    mesh = make_mesh(data=1, model=1, context=4)
    q, k, v = make_qkv(62, 1, 2, 512, 128)
    fn = make_ring_attention(
        mesh, causal=True, block_sizes=BS,
        bwd_block_sizes=BlockSizes(block_q=64, block_kv=32, num_warps=4, num_stages=2),
    )
    w = jax.random.normal(jax.random.key(5), q.shape)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    def loss_ref(q, k, v):
        return jnp.sum(
            reference_attention(q, k, v, causal=True).astype(jnp.float32) * w
        )

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, wnt, name in zip(got, want, "qkv"):
        assert_close(g, wnt, msg=f"ring grad override d{name}")
