"""Flash-attention kernel vs. fp32 oracle.

Mirrors + extends the reference's four correctness cases (C9, SURVEY.md §4;
flash_attention.cu:757-884) and fixes its documented coverage gaps: causal
long-seq, non-block-multiple seqs, GQA, residual (LSE) output, fp16 dtype.
Shapes are scaled down where the reference used seq=1024/2048 at heads=32 —
interpreter-mode runtime, same code paths (tile boundaries, masked edges).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.reference import (
    reference_attention,
    reference_attention_with_lse,
)
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu.utils.testing import assert_close, make_qkv

BS = BlockSizes(block_q=128, block_kv=64)


# The reference's four cases (ragged short causal / causal / non-causal /
# long-seq big-block tier), reduced heads for test speed.
REFERENCE_CASES = [
    dict(seq=256, heads=4, causal=True),
    dict(seq=512, heads=2, causal=True),
    dict(seq=512, heads=2, causal=False),
    dict(seq=1024, heads=1, causal=False),
    # The gap the reference never covered (SURVEY.md §4): causal long-seq.
    dict(seq=1024, heads=1, causal=True),
]


@pytest.mark.parametrize("case", REFERENCE_CASES, ids=lambda c: f"s{c['seq']}_c{int(c['causal'])}")
def test_reference_cases(case):
    q, k, v = make_qkv(42, 1, case["heads"], case["seq"], 128)
    got = flash_attention(q, k, v, causal=case["causal"], block_sizes=BS)
    want = reference_attention(q, k, v, causal=case["causal"])
    assert_close(got, want, msg=f"{case}")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [128, 200, 384, 640])
def test_ragged_seq_lengths(seq, causal):
    """Sequences that are not multiples of the block sizes (padding + masking)."""
    q, k, v = make_qkv(3, 1, 2, seq, 128)
    got = flash_attention(q, k, v, causal=causal, block_sizes=BS)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"seq={seq} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_block_size_sweep(causal):
    """Numerics must be invariant to the tile choice (Q tiles larger and
    smaller than the KV step, as the reference's 4 tiers were)."""
    q, k, v = make_qkv(9, 1, 1, 512, 128)
    want = reference_attention(q, k, v, causal=causal)
    for bq, bkv in [(128, 128), (256, 128), (128, 256), (256, 512), (512, 256)]:
        got = flash_attention(
            q, k, v, causal=causal, block_sizes=BlockSizes(block_q=bq, block_kv=bkv)
        )
        assert_close(got, want, msg=f"bq={bq} bkv={bkv} causal={causal}")


@pytest.mark.parametrize("causal", [False, True])
def test_gqa(causal):
    q, k, v = make_qkv(5, 2, 8, 256, 128, num_kv_heads=2)
    got = flash_attention(q, k, v, causal=causal, block_sizes=BS)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"gqa causal={causal}")


def test_mqa():
    q, k, v = make_qkv(6, 1, 4, 256, 128, num_kv_heads=1)
    got = flash_attention(q, k, v, causal=True, block_sizes=BS)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="mqa")


@pytest.mark.parametrize("causal", [False, True])
def test_cross_attention_kv_longer(causal):
    """q_seq != kv_seq (chunked prefill / cross attention). Causal aligns the
    last query with the last key (decode convention)."""
    q, k, v = make_qkv(8, 1, 2, 128, 128, kv_seq=512)
    got = flash_attention(q, k, v, causal=causal, block_sizes=BS)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"cross causal={causal}")


def test_fp16_io():
    q, k, v = make_qkv(11, 1, 2, 256, 128, dtype=jnp.float16)
    got = flash_attention(q, k, v, causal=True, block_sizes=BS)
    assert got.dtype == jnp.float16
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="fp16")


def test_fp32_io():
    q, k, v = make_qkv(12, 1, 2, 256, 128, dtype=jnp.float32)
    got = flash_attention(q, k, v, block_sizes=BS)
    want = reference_attention(q, k, v)
    assert_close(got, want, tolerance=1e-3, msg="fp32")


def test_head_dim_64_padding():
    q, k, v = make_qkv(13, 1, 2, 256, 64)
    got = flash_attention(q, k, v, causal=True, block_sizes=BS)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="head_dim=64")


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_64_unpadded(causal):
    """head_dim=64 stays 64 wide through the kernel (a power of two needs no
    padding); a KV step larger than the Q tile covers the other shape."""
    q, k, v = make_qkv(13, 2, 4, 384, 64)
    bs = BlockSizes(block_q=64, block_kv=128)
    got = flash_attention(q, k, v, causal=causal, block_sizes=bs)
    want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want, msg=f"head_dim=64 unpadded causal={causal}")


def test_head_dim_64_unpadded_subtile_and_hb():
    """head_dim=64 with small tiles and a GQA group walking one KV head."""
    q, k, v = make_qkv(17, 1, 8, 512, 64, num_kv_heads=2)
    bs = BlockSizes(block_q=64, block_kv=32, num_warps=4, num_stages=2)
    got = flash_attention(q, k, v, causal=True, block_sizes=bs)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="head_dim=64 small tiles + GQA")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_residuals(causal):
    q, k, v = make_qkv(14, 1, 2, 256, 128)
    got, lse2 = flash_attention(
        q, k, v, causal=causal, block_sizes=BS, save_residuals=True
    )
    want, want_lse2 = reference_attention_with_lse(q, k, v, causal=causal)
    assert_close(got, want, msg="lse output")
    np.testing.assert_allclose(
        np.asarray(lse2), np.asarray(want_lse2), atol=2e-2, rtol=1e-3
    )


def test_custom_scale():
    q, k, v = make_qkv(15, 1, 2, 256, 128)
    got = flash_attention(q, k, v, sm_scale=0.5, block_sizes=BS)
    want = reference_attention(q, k, v, sm_scale=0.5)
    assert_close(got, want, msg="sm_scale=0.5")


def test_batched():
    q, k, v = make_qkv(16, 4, 2, 256, 128)
    got = flash_attention(q, k, v, causal=True, block_sizes=BS)
    want = reference_attention(q, k, v, causal=True)
    assert_close(got, want, msg="batch=4")


def test_gqa_head_batching():
    """GQA through the KV index map (each Q head reads its group's KV head
    in place) matches the oracle across batch elements and tile choices,
    including a single KV step."""

    for (b, hq, hkv, bq, seq, causal) in [
        (2, 8, 2, 64, 256, True),
        (2, 8, 2, 128, 256, False),
        (1, 8, 4, 64, 384, True),  # group 2
        (2, 8, 2, 128, 128, False),  # one KV step
    ]:
        q, k, v = make_qkv(0, b, hq, seq, 128, num_kv_heads=hkv)
        bs = BlockSizes(block_q=bq, block_kv=128)
        got = flash_attention(q, k, v, causal=causal, block_sizes=bs)
        want = reference_attention(q, k, v, causal=causal)
        assert_close(got, want, msg=f"b={b} hq={hq} hkv={hkv} bq={bq}")


def test_causal_subtile_configs():
    """Causal tiles where the diagonal crosses one Q tile (masked edge of
    several KV steps) must match the oracle across MHA/GQA, padding, and
    kv_len > q_len diagonal offsets."""
    cases = [
        # (batch, q_heads, kv_heads, q_len, kv_len, bs)
        (1, 4, 4, 512, 512, BlockSizes(256, 64)),
        (1, 4, 4, 640, 640, BlockSizes(256, 128)),  # ragged pad
        (2, 8, 2, 512, 512, BlockSizes(128, 32, 4, 2)),  # GQA index map
        (1, 2, 2, 256, 512, BlockSizes(256, 64)),  # diag offset
        (1, 2, 2, 512, 512, BlockSizes(512, 128, 8, 2)),  # one Q tile
    ]
    for batch, hq, hkv, qs, ks, bs in cases:
        q, k, v = make_qkv(11, batch, hq, qs, 128, num_kv_heads=hkv, kv_seq=ks)
        got = flash_attention(q, k, v, causal=True, block_sizes=bs)
        want = reference_attention(q, k, v, causal=True)
        assert_close(got, want, msg=f"subtile {bs}")


def test_causal_subtile_lse_matches_tiled():
    """One whole-sequence Q tile's LSE residual must agree with the tiled
    online-softmax path (the split/ring merge contract)."""
    q, k, v = make_qkv(12, 1, 2, 512, 128)
    out_a, lse_a = flash_attention(
        q, k, v, causal=True, save_residuals=True,
        block_sizes=BlockSizes(512, 256, 8, 2),
    )
    out_b, lse_b = flash_attention(
        q, k, v, causal=True, save_residuals=True, block_sizes=BS
    )
    assert_close(out_a, out_b)
    np.testing.assert_allclose(
        np.asarray(lse_a), np.asarray(lse_b), rtol=1e-3, atol=1e-3
    )


def test_causal_subtile_softcap():
    q, k, v = make_qkv(13, 1, 2, 512, 128)
    got = flash_attention(
        q, k, v, causal=True, logit_softcap=30.0,
        block_sizes=BlockSizes(512, 256, 8, 2),
    )
    want = reference_attention(q, k, v, causal=True, logit_softcap=30.0)
    assert_close(got, want)


def test_causal_diag_subtile_configs():
    """Multi-tile causal: each Q tile's KV walk splits into a mask-free
    interior and masked diagonal steps. Must match the oracle across
    MHA/GQA, tile shapes, and aligned chunked-prefill offsets."""
    cases = [
        # (batch, q_heads, kv_heads, q_len, kv_len, bs)
        (1, 2, 2, 512, 512, BlockSizes(128, 128)),  # square tiles
        (1, 2, 2, 512, 512, BlockSizes(256, 256)),
        (1, 2, 2, 768, 768, BlockSizes(256, 64)),
        (2, 4, 4, 512, 512, BlockSizes(64, 256)),  # KV step > Q tile
        (1, 8, 2, 512, 512, BlockSizes(128, 32)),  # GQA
        (1, 2, 2, 1024, 1024, BlockSizes(256, 128)),
        # aligned chunked-prefill: q_len < kv_len, offset % block_kv == 0
        (1, 2, 2, 256, 512, BlockSizes(128, 128)),
    ]
    for batch, hq, hkv, qs, ks, bs in cases:
        q, k, v = make_qkv(17, batch, hq, qs, 128, num_kv_heads=hkv, kv_seq=ks)
        got = flash_attention(q, k, v, causal=True, block_sizes=bs)
        want = reference_attention(q, k, v, causal=True)
        assert_close(got, want, msg=f"diag subtile {qs}/{ks} {bs}")


def test_causal_diag_subtile_lse_and_grad():
    """LSE must not depend on the tiles, and the backward (which consumes
    the residuals forward) must stay correct."""
    import jax

    q, k, v = make_qkv(18, 1, 2, 768, 128)
    bs = BlockSizes(256, 128)
    out_a, lse_a = flash_attention(
        q, k, v, causal=True, save_residuals=True, block_sizes=bs
    )
    out_b, lse_b = flash_attention(
        q, k, v, causal=True, save_residuals=True, block_sizes=BS
    )
    assert_close(out_a, out_b)
    np.testing.assert_allclose(
        np.asarray(lse_a), np.asarray(lse_b), rtol=1e-3, atol=1e-3
    )

    def loss(q, k, v):
        return jnp.sum(
            flash_attention(q, k, v, causal=True, block_sizes=bs).astype(
                jnp.float32
            )
            ** 2
        )

    def loss_ref(q, k, v):
        return jnp.sum(
            reference_attention(q, k, v, causal=True).astype(jnp.float32) ** 2
        )

    got = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    want = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    for g, w, name in zip(got, want, "qkv"):
        assert_close(g, w, msg=f"d{name}")


def test_causal_diag_subtile_softcap():
    q, k, v = make_qkv(19, 1, 2, 512, 128)
    got = flash_attention(
        q, k, v, causal=True, logit_softcap=30.0,
        block_sizes=BlockSizes(256, 128),
    )
    want = reference_attention(q, k, v, causal=True, logit_softcap=30.0)
    assert_close(got, want)


def test_rejects_batch_or_head_dim_mismatch():
    """A q/kv batch mismatch must raise: the KV index map would otherwise
    read another batch element's K/V rows."""
    import pytest

    q, k, v = make_qkv(70, 2, 2, 128, 128)
    with pytest.raises(ValueError, match="q/kv shape mismatch"):
        flash_attention(q, k[:1], v[:1], causal=True)
    with pytest.raises(ValueError, match="q/kv shape mismatch"):
        flash_attention(q[:, :, :, :64], k, v, causal=True)


@pytest.mark.parametrize(
    "bad", [dict(block_q=96), dict(block_kv=8), dict(num_warps=3),
            dict(num_stages=0)],
)
def test_block_sizes_reject_non_triton_tiles(bad):
    """Triton tiles are powers of two >= 16 with a power-of-two warp count;
    anything else is refused at construction, not at GPU compile time."""
    with pytest.raises(ValueError):
        BlockSizes(**bad)
