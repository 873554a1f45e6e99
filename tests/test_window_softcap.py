"""Sliding-window (local) attention and logit soft-capping vs the oracle."""

import jax
import jax.numpy as jnp
import pytest

from flash_attention_tpu.ops.decode import decode_attention
from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.ops.tuning import BlockSizes
from flash_attention_tpu.utils.testing import assert_close, make_qkv


@pytest.mark.parametrize("window", [64, 128, 300])
def test_sliding_window_forward(window):
    q, k, v = make_qkv(0, 1, 2, 512, 128)
    bs = BlockSizes(block_q=128, block_kv=64)
    got = flash_attention(q, k, v, causal=True, sliding_window=window, block_sizes=bs)
    want = reference_attention(q, k, v, causal=True, sliding_window=window)
    assert_close(got, want)


def test_sliding_window_single_tile():
    q, k, v = make_qkv(1, 1, 2, 256, 128)
    got = flash_attention(q, k, v, causal=True, sliding_window=100)
    want = reference_attention(q, k, v, causal=True, sliding_window=100)
    assert_close(got, want)


def test_sliding_window_chunked_prefill():
    # kv longer than q (decode-aligned diagonal) with a window.
    q, k, v = make_qkv(2, 1, 2, 128, 128, kv_seq=384)
    bs = BlockSizes(block_q=64, block_kv=64)
    got = flash_attention(q, k, v, causal=True, sliding_window=200, block_sizes=bs)
    want = reference_attention(q, k, v, causal=True, sliding_window=200)
    assert_close(got, want)


def test_softcap_forward():
    q, k, v = make_qkv(3, 1, 2, 384, 128)
    # Scale q up so scores actually exceed the cap (otherwise tanh ~ identity
    # and the test proves nothing).
    q = (q.astype(jnp.float32) * 8).astype(q.dtype)
    for causal in (False, True):
        got = flash_attention(q, k, v, causal=causal, logit_softcap=1.0)
        want = reference_attention(q, k, v, causal=causal, logit_softcap=1.0)
        assert_close(got, want, msg=f"causal={causal}")
        # The cap must change the answer (guard against a silently-ignored arg).
        plain = reference_attention(q, k, v, causal=causal)
        assert float(jnp.max(jnp.abs(want.astype(jnp.float32) - plain.astype(jnp.float32)))) > 0.01


def test_softcap_with_window_multiblock():
    q, k, v = make_qkv(4, 1, 2, 512, 128)
    q = (q.astype(jnp.float32) * 8).astype(q.dtype)
    bs = BlockSizes(block_q=64, block_kv=128)
    got = flash_attention(
        q, k, v, causal=True, sliding_window=192, logit_softcap=2.0, block_sizes=bs
    )
    want = reference_attention(
        q, k, v, causal=True, sliding_window=192, logit_softcap=2.0
    )
    assert_close(got, want)


def test_decode_window_and_softcap():
    q, k, v = make_qkv(5, 3, 4, 1, 128, num_kv_heads=2, kv_seq=512)
    q = q[:, :, 0, :]
    lengths = jnp.asarray([512, 300, 70], jnp.int32)
    for window, cap in ((128, None), (None, 15.0), (200, 15.0)):
        got = decode_attention(
            q, k, v, lengths, block_kv=128,
            sliding_window=window, logit_softcap=cap,
        )
        # Oracle: single-row causal-at-end == length mask + window around the
        # last position.
        want = reference_attention(
            q[:, :, None, :], k, v, kv_length=lengths,
            logit_softcap=cap, causal=False,
        )
        if window is not None:
            # apply window manually: col >= length - window
            col = jnp.arange(512)[None, :]
            keep = (col >= (lengths[:, None] - window)) & (col < lengths[:, None])
            import numpy as np

            from flash_attention_tpu.ops.quant import dequantize  # noqa: F401
            # recompute oracle with combined mask via kv_length trick:
            qf = q[:, :, None, :].astype(jnp.float32)
            kf = jnp.repeat(k.astype(jnp.float32), 2, axis=1)
            vf = jnp.repeat(v.astype(jnp.float32), 2, axis=1)
            s = jnp.einsum("bhqd,bhkd->bhqk", qf, kf) * (128 ** -0.5)
            if cap is not None:
                s = cap * jnp.tanh(s / cap)
            s = jnp.where(keep[:, None, None, :], s, -1e30)
            w = jax.nn.softmax(s, axis=-1)
            want = jnp.einsum("bhqk,bhkd->bhqd", w, vf).astype(q.dtype)
        assert_close(got, want[:, :, 0, :], msg=f"window={window} cap={cap}")


@pytest.mark.parametrize(
    "window,cap",
    [(64, None), (300, None), (None, 1.0), (192, 2.0)],
)
def test_window_softcap_grads_match_oracle(window, cap):
    from tests.test_backward import grads

    q, k, v = make_qkv(6, 1, 2, 512, 128)
    if cap is not None:
        # Scale q up so scores exceed the cap (tanh' != 1 somewhere).
        q = (q.astype(jnp.float32) * 8).astype(q.dtype)
    bs = BlockSizes(block_q=64, block_kv=64)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=True, sliding_window=window, logit_softcap=cap,
            block_sizes=bs, bwd_block_sizes=bs,
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=True, sliding_window=window, logit_softcap=cap,
            out_dtype=jnp.float32,
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, msg=f"{name} (window={window} cap={cap}):")


def test_window_grad_chunked_prefill():
    # kv longer than q (diag offset) + window, through both bwd kernels.
    from tests.test_backward import grads

    q, k, v = make_qkv(9, 1, 2, 128, 128, kv_seq=384)
    bs = BlockSizes(block_q=32, block_kv=64)
    got = grads(
        lambda q, k, v: flash_attention(
            q, k, v, causal=True, sliding_window=200,
            block_sizes=bs, bwd_block_sizes=bs,
        ),
        q, k, v,
    )
    want = grads(
        lambda q, k, v: reference_attention(
            q, k, v, causal=True, sliding_window=200, out_dtype=jnp.float32
        ),
        q, k, v,
    )
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert_close(g, w, msg=f"{name}:")


def test_window_validation():
    q, k, v = make_qkv(7, 1, 2, 128, 128)
    with pytest.raises(ValueError, match="requires causal"):
        flash_attention(q, k, v, sliding_window=64)
    with pytest.raises(ValueError, match="logit_softcap"):
        flash_attention(q, k, v, logit_softcap=-1.0)


def test_paged_decode_window_softcap():
    from tests.test_paged import build_scattered_cache
    from flash_attention_tpu.ops.paged import paged_decode_attention
    import numpy as np

    lengths = np.array([512, 300, 70], np.int32)
    cache, k, v = build_scattered_cache(6, 3, 2, lengths, 4)
    q, _, _ = make_qkv(8, 3, 4, 1, 128)
    q = q[:, :, 0, :]
    got = paged_decode_attention(q, cache, sliding_window=150, logit_softcap=5.0)
    want = decode_attention(
        q, k, v, jnp.asarray(lengths), block_kv=128,
        sliding_window=150, logit_softcap=5.0,
    )
    assert_close(got, want)


def test_window_band_fast_path_matches_oracle():
    """window == block_kv: every Q tile's band is exactly its leading-edge
    tile plus its diagonal tile (a masked walk with no mask-free middle)."""
    q, k, v = make_qkv(41, 2, 4, 768, 128)
    want = reference_attention(q, k, v, causal=True, sliding_window=256)
    got = flash_attention(
        q, k, v, causal=True, sliding_window=256,
        block_sizes=BlockSizes(256, 256, 8, 2),
    )
    assert_close(got, want)
    # Residuals (under-grad forward) with the Q tile smaller than the band.
    got2, lse = flash_attention(
        q, k, v, causal=True, sliding_window=256, save_residuals=True,
        block_sizes=BlockSizes(128, 256, 8, 2),
    )
    assert_close(got2, want)
    # Gradients through the windowed backward kernels.
    def loss(q, k, v):
        return jnp.sum(
            flash_attention(
                q, k, v, causal=True, sliding_window=256,
                block_sizes=BlockSizes(256, 256, 8, 2),
            ).astype(jnp.float32)
        )

    def loss_ref(q, k, v):
        return jnp.sum(
            reference_attention(
                q, k, v, causal=True, sliding_window=256
            ).astype(jnp.float32)
        )

    dq, dk, dv = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    rq, rk, rv = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    assert_close(dq, rq, msg="dq")
    assert_close(dk, rk, msg="dk")
    assert_close(dv, rv, msg="dv")
