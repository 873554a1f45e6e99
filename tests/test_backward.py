"""Gradient tests: Triton dq / dkv backward vs jax.grad of the fp32 oracle.

The reference has no backward kernel (SURVEY.md §2), so there is no CUDA
contract to mirror; the bar here is agreement with autodiff through the fp32
reference attention at the reference's 0.1 absolute tolerance (values are
O(1) U(-0.5,0.5) inputs, so gradients are O(1) too).
"""

import jax
import jax.numpy as jnp
import pytest

from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu.utils.testing import assert_close, make_qkv


def grads(fn, q, k, v, seed=7):
    # Random cotangent; scalar loss = sum(out * w) so d loss/d out = w.
    w = jax.random.normal(jax.random.key(seed), q.shape[:-1] + (v.shape[-1],))

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


CASES = [
    # batch, hq, hkv, q_len, kv_len, causal
    (1, 2, 2, 256, 256, False),
    (1, 2, 2, 256, 256, True),
    (2, 4, 2, 128, 128, True),    # GQA group=2: dk/dv sum over the group
    (1, 8, 1, 128, 128, False),   # MQA
    (1, 2, 2, 192, 192, True),    # ragged: not a block multiple
    (1, 2, 2, 128, 384, True),    # chunked prefill: kv longer, diag offset
    (1, 2, 2, 128, 320, False),   # cross attention, ragged kv
]


@pytest.mark.parametrize("batch,hq,hkv,q_len,kv_len,causal", CASES)
def test_grads_match_oracle(batch, hq, hkv, q_len, kv_len, causal):
    q, k, v = make_qkv(3, batch, hq, q_len, 128, num_kv_heads=hkv, kv_seq=kv_len)
    bs = BlockSizes(block_q=64, block_kv=64)

    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=causal, block_sizes=bs, bwd_block_sizes=bs
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=causal, out_dtype=jnp.float32
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, msg=f"{name}:")


def test_grads_multi_block_shapes():
    """Blocks smaller than seq in both q and kv axes (multi-step accumulation)."""
    q, k, v = make_qkv(4, 1, 2, 512, 128)
    bs = BlockSizes(block_q=128, block_kv=256)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=True, block_sizes=bs, bwd_block_sizes=bs
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=True, out_dtype=jnp.float32
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, msg=f"{name}:")


def test_custom_scale():
    q, k, v = make_qkv(5, 1, 2, 128, 128)
    bs = BlockSizes(block_q=128, block_kv=128)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, sm_scale=0.2, block_sizes=bs, bwd_block_sizes=bs
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, sm_scale=0.2, out_dtype=jnp.float32
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, msg=f"{name}:")


def test_value_and_grad_consistent_with_fwd_only():
    """The custom-VJP path must produce the same forward value."""
    q, k, v = make_qkv(6, 1, 2, 256, 256)
    out_plain = flash_attention(q, k, v, causal=True)
    out_vjp, _ = jax.vjp(
        lambda q, k, v: flash_attention(q, k, v, causal=True), q, k, v
    )
    assert jnp.array_equal(out_plain, out_vjp)


def test_bwd_diag_subtile():
    """Multi-tile causal in both bwd kernels: the dq walk over KV tiles
    and the dkv walk over Q tiles each split into masked diagonal steps and
    a mask-free interior."""
    cases = [
        # (batch, hq, hkv, seq, bs)
        (1, 2, 2, 512, BlockSizes(64, 64)),
        (1, 2, 2, 768, BlockSizes(128, 64)),
        (2, 4, 1, 512, BlockSizes(64, 128)),  # GQA group walk
        (1, 2, 2, 1024, BlockSizes(128, 128)),
    ]
    for batch, hq, hkv, seq, bs in cases:
        q, k, v = make_qkv(23, batch, hq, seq, 128, num_kv_heads=hkv)
        got = grads(
            lambda q, k, v: flash_attention(
                q, k, v, causal=True, block_sizes=bs, bwd_block_sizes=bs
            ),
            q, k, v,
        )
        want = grads(
            lambda q, k, v: reference_attention(q, k, v, causal=True), q, k, v
        )
        for g, w, name in zip(got, want, "qkv"):
            assert_close(g, w, msg=f"seq={seq} {bs} d{name}")


def test_bwd_diag_subtile_softcap():
    q, k, v = make_qkv(24, 1, 2, 512, 128)
    bs = BlockSizes(128, 64)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=True, block_sizes=bs, bwd_block_sizes=bs,
            logit_softcap=20.0,
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=True, logit_softcap=20.0
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, "qkv"):
        assert_close(g, w, msg=f"softcap d{name}")


TILE_CASES = [
    # (batch, hq, q_len, kv_len, causal, bs) — the backward tiles: the dq
    # kernel holds block_q rows and walks block_kv steps, the dkv kernel
    # holds block_kv rows and walks block_q steps.
    (1, 2, 256, 256, False, BlockSizes(64, 64)),
    (1, 2, 512, 512, True, BlockSizes(64, 128)),
    (2, 2, 384, 384, True, BlockSizes(128, 64)),
    (1, 2, 192, 192, True, BlockSizes(64, 64)),  # ragged
    (1, 2, 128, 384, True, BlockSizes(32, 64)),  # diag offset
    (1, 2, 128, 320, False, BlockSizes(64, 64)),  # ragged kv
    (1, 4, 512, 512, True, BlockSizes(64, 32, 4, 2)),
    # One Q tile covering the whole sequence.
    (1, 2, 512, 512, True, BlockSizes(512, 64, 8, 2)),
    # Many small diagonal steps.
    (1, 2, 1024, 1024, True, BlockSizes(128, 32)),
    (1, 2, 512, 512, True, BlockSizes(16, 64, 1, 1)),
    (1, 2, 768, 768, True, BlockSizes(256, 128, 8, 2)),
    (1, 2, 512, 512, False, BlockSizes(128, 16, 2, 1)),
    (1, 2, 448, 448, False, BlockSizes(128, 256)),  # ragged, padded tail
]


@pytest.mark.parametrize("batch,hq,q_len,kv_len,causal,bs", TILE_CASES)
def test_bwd_tile_choices(batch, hq, q_len, kv_len, causal, bs):
    """Every backward tile choice matches autodiff through the fp32
    oracle."""
    q, k, v = make_qkv(31, batch, hq, q_len, 128, kv_seq=kv_len)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=causal, block_sizes=BlockSizes(128, 64),
            bwd_block_sizes=bs,
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=causal, out_dtype=jnp.float32
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, "qkv"):
        assert_close(g, w, msg=f"tiles {bs} d{name}")


def test_bwd_window_softcap():
    q, k, v = make_qkv(32, 1, 2, 512, 128)
    bs = BlockSizes(64, 32)
    for kwargs in (
        {"sliding_window": 200},
        {"logit_softcap": 20.0},
        {"sliding_window": 300, "logit_softcap": 15.0},
    ):
        got = grads(
            lambda q, k, v: flash_attention(
                q, k, v, causal=True, block_sizes=BlockSizes(128, 64),
                bwd_block_sizes=bs, **kwargs,
            ),
            q, k, v,
        )
        want = grads(
            lambda q, k, v: reference_attention(
                q, k, v, causal=True, **kwargs
            ),
            q, k, v,
        )
        for g, w, name in zip(got, want, "qkv"):
            assert_close(g, w, msg=f"{kwargs} d{name}")
