"""Packed-sequence (segment ids) attention vs the fp32 oracle.

The reference has no packing support (single-sequence benchmark); this is the
packed-pretraining contract: positions attend only within their own segment,
composing with causal masking, GQA, tile choices, soft-caps, and
gradients. A packed batch must reproduce the per-document unpacked results
exactly (up to the usual 0.1 fused-kernel tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu.utils.testing import assert_close, make_qkv


def make_segments(batch, seq, boundaries):
    """Segment ids [batch, seq] splitting each row at `boundaries`."""
    ids = np.zeros((batch, seq), np.int32)
    for b in range(batch):
        for i, cut in enumerate(boundaries):
            ids[b, cut:] = i + 1
    return jnp.asarray(ids)


@pytest.mark.parametrize("causal", [False, True])
def test_segments_match_oracle(causal):
    q, k, v = make_qkv(31, 2, 4, 256, 128)
    seg = make_segments(2, 256, [100, 180])
    got = flash_attention(
        q, k, v, causal=causal, segment_ids=seg,
        block_sizes=BlockSizes(128, 64),
    )
    want = reference_attention(q, k, v, causal=causal, segment_ids=seg)
    assert_close(got, want, msg=f"causal={causal}")


def test_segments_subtile_config():
    """Segment masking with one whole-sequence Q tile walking small KV
    steps."""
    q, k, v = make_qkv(32, 1, 4, 512, 128)
    seg = make_segments(1, 512, [200, 400])
    got = flash_attention(
        q, k, v, causal=True, segment_ids=seg,
        block_sizes=BlockSizes(512, 64, 8, 2),
    )
    want = reference_attention(q, k, v, causal=True, segment_ids=seg)
    assert_close(got, want)


def test_segments_gqa_and_softcap():
    q, k, v = make_qkv(33, 2, 8, 256, 128, num_kv_heads=2)
    seg = make_segments(2, 256, [128])
    got = flash_attention(
        q, k, v, causal=True, segment_ids=seg, logit_softcap=30.0,
        block_sizes=BlockSizes(64, 128),
    )
    want = reference_attention(
        q, k, v, causal=True, segment_ids=seg, logit_softcap=30.0
    )
    assert_close(got, want)


def test_packed_equals_unpacked():
    """A 2-doc packed row must equal the two docs attended separately."""
    q, k, v = make_qkv(34, 1, 2, 256, 128)
    cut = 128
    seg = make_segments(1, 256, [cut])
    packed = flash_attention(
        q, k, v, causal=True, segment_ids=seg,
        block_sizes=BlockSizes(128, 128),
    )
    doc0 = flash_attention(
        q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], causal=True,
        block_sizes=BlockSizes(128, 128),
    )
    doc1 = flash_attention(
        q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], causal=True,
        block_sizes=BlockSizes(128, 128),
    )
    np.testing.assert_allclose(
        np.asarray(packed[:, :, :cut], np.float32),
        np.asarray(doc0, np.float32), rtol=0.02, atol=0.02,
    )
    np.testing.assert_allclose(
        np.asarray(packed[:, :, cut:], np.float32),
        np.asarray(doc1, np.float32), rtol=0.02, atol=0.02,
    )


def test_segments_gradients():
    """Backward: packed grads must match jax.grad of the oracle."""
    q, k, v = make_qkv(35, 1, 2, 256, 128)
    seg = make_segments(1, 256, [150])

    def f(q, k, v):
        return jnp.sum(
            flash_attention(
                q, k, v, causal=True, segment_ids=seg,
                block_sizes=BlockSizes(128, 64),
                bwd_block_sizes=BlockSizes(64, 32),
            ).astype(jnp.float32)
        )

    def g(q, k, v):
        return jnp.sum(
            reference_attention(
                q, k, v, causal=True, segment_ids=seg
            ).astype(jnp.float32)
        )

    got = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(g, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got, want):
        err = float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))
        assert err < 0.1, f"d{name} max err {err}"


def test_segments_validation():
    q, k, v = make_qkv(36, 1, 2, 128, 128)
    with pytest.raises(ValueError, match="segment_ids shape"):
        flash_attention(q, k, v, segment_ids=jnp.zeros((1, 64), jnp.int32))
    q2 = q[:, :, :64]
    with pytest.raises(ValueError, match="q_seq == kv_seq"):
        flash_attention(
            q2, k, v, causal=True,
            segment_ids=jnp.zeros((1, 128), jnp.int32),
        )


def test_train_forward_packed_equals_unpacked():
    """Model-level packed training: a packed row's logits must equal each
    document run separately (per-document RoPE positions + segment mask)."""
    from flash_attention_tpu.models.transformer import (
        ModelConfig,
        init_model_params,
        segment_positions,
        train_forward,
    )

    cfg = ModelConfig(
        vocab_size=128, model_dim=128, num_layers=2, num_q_heads=4,
        num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
    )
    params = init_model_params(jax.random.key(0), cfg)
    doc0 = jnp.asarray([[5, 9, 2, 77, 31, 8]], jnp.int32)
    doc1 = jnp.asarray([[100, 3, 44, 61]], jnp.int32)
    packed = jnp.concatenate([doc0, doc1], axis=1)  # [1, 10]
    seg = jnp.asarray([[0] * 6 + [1] * 4], jnp.int32)

    np.testing.assert_array_equal(
        np.asarray(segment_positions(seg)[0]),
        [0, 1, 2, 3, 4, 5, 0, 1, 2, 3],
    )

    logits = train_forward(params, cfg, packed, segment_ids=seg)
    l0 = train_forward(params, cfg, doc0)
    l1 = train_forward(params, cfg, doc1)
    np.testing.assert_allclose(
        np.asarray(logits[:, :6]), np.asarray(l0), rtol=2e-4, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(logits[:, 6:]), np.asarray(l1), rtol=2e-4, atol=2e-4
    )


def test_train_forward_packed_grads_finite():
    from flash_attention_tpu.models.transformer import (
        ModelConfig,
        init_model_params,
        train_forward,
    )

    cfg = ModelConfig(
        vocab_size=64, model_dim=128, num_layers=1, num_q_heads=4,
        num_kv_heads=2, head_dim=32, mlp_dim=256, dtype="float32",
    )
    params = init_model_params(jax.random.key(1), cfg)
    tokens = jnp.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], jnp.int32)
    seg = jnp.asarray([[0, 0, 0, 1, 1, 1, 1, 1]], jnp.int32)

    def loss(p):
        logits = train_forward(p, cfg, tokens, segment_ids=seg)
        logp = jax.nn.log_softmax(logits[:, :-1])
        tgt = tokens[:, 1:]
        return -jnp.mean(jnp.take_along_axis(logp, tgt[..., None], -1))

    val, grads = jax.value_and_grad(loss)(params)
    assert np.isfinite(float(val))
    for leaf in jax.tree_util.tree_leaves(grads):
        assert np.isfinite(np.asarray(leaf)).all()


def test_packed_skip_multiblock_fwd_bwd():
    """Packed tile skipping (per-tile live ranges from the segment ids, in
    the forward and both backward kernels): per-batch-row layouts, doc
    boundaries crossing tile boundaries, vs the oracle — values AND
    gradients."""
    q, k, v = make_qkv(41, 2, 2, 512, 128)
    ids = np.zeros((2, 512), np.int32)
    ids[0, 128:384] = 1
    ids[0, 384:] = 2
    ids[1, 300:] = 1  # boundary inside a block
    seg = jnp.asarray(ids)
    bs = BlockSizes(128, 128)
    got = flash_attention(
        q, k, v, causal=True, segment_ids=seg, block_sizes=bs
    )
    want = reference_attention(q, k, v, causal=True, segment_ids=seg)
    assert_close(got, want)

    w = jax.random.normal(jax.random.key(7), q.shape)

    def f(q, k, v):
        return jnp.sum(
            flash_attention(
                q, k, v, causal=True, segment_ids=seg,
                block_sizes=bs, bwd_block_sizes=bs,
            ).astype(jnp.float32) * w
        )

    def g(q, k, v):
        return jnp.sum(
            reference_attention(
                q, k, v, causal=True, segment_ids=seg
            ).astype(jnp.float32) * w
        )

    got_g = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    want_g = jax.grad(g, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got_g, want_g):
        err = float(
            jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32)))
        )
        assert err < 0.1, f"d{name} max err {err}"


def test_packed_skip_gqa_ragged():
    """GQA + a seq that pads to the block grid (pad sentinels must read as
    dead blocks, with the forced-live diagonal preserving the zero-output
    contract for fully-masked rows)."""
    q, k, v = make_qkv(42, 2, 4, 600, 128, num_kv_heads=2)
    ids = np.zeros((2, 600), np.int32)
    ids[0, 200:400] = 1
    ids[0, 400:] = 2
    ids[1, 450:] = 1
    seg = jnp.asarray(ids)
    bs = BlockSizes(128, 64)
    got = flash_attention(
        q, k, v, causal=True, segment_ids=seg, block_sizes=bs
    )
    want = reference_attention(q, k, v, causal=True, segment_ids=seg)
    assert_close(got, want)


def test_packed_skip_chunked_cross_lengths():
    """q shorter than kv (chunked-prefill shape) with segment ids on both
    sides still takes the skip path (single q block, multi kv block)."""
    q, k, v = make_qkv(43, 1, 4, 256, 128, kv_seq=640)
    sq = jnp.asarray(
        np.concatenate([np.full(100, 7), np.full(156, 8)])[None].astype(
            np.int32
        )
    )
    skv = jnp.asarray(
        np.concatenate(
            [np.full(300, 6), np.full(184, 7), np.full(156, 8)]
        )[None].astype(np.int32)
    )
    bs = BlockSizes(256, 64)
    got = flash_attention(
        q, k, v, causal=True, segment_ids=(sq, skv), block_sizes=bs
    )
    want = reference_attention(q, k, v, causal=True, segment_ids=(sq, skv))
    assert_close(got, want)


def test_packed_skip_noncausal():
    """Non-causal (encoder-style) packed batches: the dense grid is gated
    through the prefetched liveness table with [first, last]-band DMA
    clamps — values, residuals, and gradients vs the oracle."""
    q, k, v = make_qkv(45, 2, 2, 512, 128)
    ids = np.zeros((2, 512), np.int32)
    ids[0, 128:384] = 1
    ids[0, 384:] = 2
    ids[1, 300:] = 1
    seg = jnp.asarray(ids)
    bs = BlockSizes(128, 128)
    got = flash_attention(
        q, k, v, causal=False, segment_ids=seg, block_sizes=bs
    )
    want = reference_attention(q, k, v, causal=False, segment_ids=seg)
    assert_close(got, want)

    w = jax.random.normal(jax.random.key(9), q.shape)

    def f(q, k, v):
        return jnp.sum(
            flash_attention(
                q, k, v, causal=False, segment_ids=seg,
                block_sizes=bs, bwd_block_sizes=bs,
            ).astype(jnp.float32) * w
        )

    def g(q, k, v):
        return jnp.sum(
            reference_attention(
                q, k, v, causal=False, segment_ids=seg
            ).astype(jnp.float32) * w
        )

    got_g = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    want_g = jax.grad(g, argnums=(0, 1, 2))(q, k, v)
    for name, a, b in zip("qkv", got_g, want_g):
        err = float(
            jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32)))
        )
        assert err < 0.1, f"d{name} max err {err}"


def test_packed_skip_enumeration_math():
    """The per-tile live ranges, checked directly on a hand-built layout:
    two documents of two tiles each keep each Q tile on its own document's
    KV tiles (and vice versa), and pad sentinels never extend a range."""
    from flash_attention_tpu.ops.flash_attention import (
        pad_segments,
        segment_block_bounds,
    )

    seg = make_segments(1, 480, [256])  # docs [0, 256) and [256, 480)
    seg_q, seg_kv = pad_segments((seg, seg), 480, 512, 480, 512)
    q_bounds, kv_bounds = segment_block_bounds(
        seg_q, seg_kv, 128, 128, 480, 480
    )
    assert np.asarray(q_bounds)[0].tolist() == [[0, 2], [0, 2], [2, 4], [2, 4]]
    assert np.asarray(kv_bounds)[0].tolist() == [[0, 2], [0, 2], [2, 4], [2, 4]]
    # A Q tile whose ids match no KV tile gets an empty range.
    none = segment_block_bounds(
        jnp.full((1, 128), 5, jnp.int32), jnp.zeros((1, 256), jnp.int32),
        128, 128, 128, 256,
    )[0]
    assert np.asarray(none)[0].tolist() == [[0, 0]]


@pytest.mark.parametrize("causal", [False, True])
def test_grads_finite_on_dead_segment_rows(causal):
    """Q rows whose segment id appears nowhere in the KV ids are fully
    masked: the forward emits zeros with lse2 = -inf, and the backward must
    treat them as zero-gradient rows — not exp2(+inf) = inf poisoning dq
    (NaN) and every dk/dv accumulator sharing the head batch."""
    q, k, v = make_qkv(13, 1, 2, 128, 128)
    q_ids = jnp.concatenate(
        [jnp.zeros((1, 64), jnp.int32), jnp.full((1, 64), 2, jnp.int32)],
        axis=1,
    )
    kv_ids = jnp.zeros((1, 128), jnp.int32)
    w = jax.random.normal(jax.random.key(4), q.shape)

    def loss(q, k, v):
        out = flash_attention(
            q, k, v, causal=causal, segment_ids=(q_ids, kv_ids)
        )
        return jnp.sum(out.astype(jnp.float32) * w)

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for g, name in ((dq, "dq"), (dk, "dk"), (dv, "dv")):
        assert bool(jnp.all(jnp.isfinite(g.astype(jnp.float32)))), name
    # Dead rows get exactly zero gradient...
    assert bool(jnp.all(dq[:, :, 64:] == 0))

    # ...and the live half matches an oracle over only the live rows. For
    # the causal case restrict KV to the same prefix (the oracle END-aligns
    # causal when Sq != Skv, which is the decode convention, not this one);
    # live row i sees cols <= i <= 63 either way.
    kv_keep = 64 if causal else 128
    k_live, v_live = k[:, :, :kv_keep], v[:, :, :kv_keep]

    def loss_ref(q_live, k_live, v_live):
        out = reference_attention(q_live, k_live, v_live, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * w[:, :, :64])

    rq, rk, rv = jax.grad(loss_ref, argnums=(0, 1, 2))(
        q[:, :, :64], k_live, v_live
    )
    assert_close(dq[:, :, :64], rq, msg="dq live")
    assert_close(dk[:, :, :kv_keep], rk, msg="dk")
    assert_close(dv[:, :, :kv_keep], rv, msg="dv")
    # KV columns no live row can reach carry zero gradient.
    assert bool(jnp.all(dk[:, :, kv_keep:] == 0))
    assert bool(jnp.all(dv[:, :, kv_keep:] == 0))


def test_packed_fused_backward_matches_oracle():
    """The backward kernels on packed causal self-attention (per-tile live
    ranges + segment mask); grads must match the oracle for aligned and
    unaligned document layouts, with two backward tile choices."""
    from flash_attention_tpu.ops.tuning import BlockSizes

    q, k, v = make_qkv(61, 1, 2, 256, 128)
    w = jax.random.normal(jax.random.key(6), q.shape)
    for boundaries in ([128], [100, 180]):
        seg = make_segments(1, 256, boundaries)

        def loss(f):
            def g(q, k, v):
                return jnp.sum(f(q, k, v).astype(jnp.float32) * w)

            return g

        ref = jax.grad(
            loss(
                lambda q, k, v: reference_attention(
                    q, k, v, causal=True, segment_ids=seg
                )
            ),
            argnums=(0, 1, 2),
        )(q, k, v)
        for bwd in (BlockSizes(64, 64), BlockSizes(32, 128, 4, 2)):
            ours = jax.grad(
                loss(
                    lambda q, k, v: flash_attention(
                        q, k, v, causal=True, segment_ids=seg,
                        bwd_block_sizes=bwd,
                    )
                ),
                argnums=(0, 1, 2),
            )(q, k, v)
            for a, b, name in zip(ours, ref, ("dq", "dk", "dv")):
                assert_close(a, b, msg=f"{name} {boundaries} {bwd}")
