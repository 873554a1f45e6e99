"""Decode (flash-decoding) kernel vs. oracle, incl. quantized KV caches."""

import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.decode import decode_attention, decode_attention_split
from flash_attention_tpu.ops.quant import dequantize, quantize_kv
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.utils.testing import assert_close, make_qkv


def _decode_oracle(q, k, v, lengths):
    out = reference_attention(q[:, :, None, :], k, v, kv_length=lengths)
    return out[:, :, 0, :]


def test_decode_mha():
    q, k, v = make_qkv(31, 2, 4, 1, 128, kv_seq=512)
    q = q[:, :, 0, :]
    lengths = jnp.array([512, 300], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode mha")


def test_decode_gqa():
    q, k, v = make_qkv(32, 2, 8, 1, 128, num_kv_heads=2, kv_seq=384)
    q = q[:, :, 0, :]
    lengths = jnp.array([384, 129], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode gqa")


def test_decode_short_lengths():
    """Lengths smaller than one KV block, incl. length=1."""
    q, k, v = make_qkv(33, 3, 2, 1, 128, kv_seq=256)
    q = q[:, :, 0, :]
    lengths = jnp.array([1, 17, 128], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode short lengths")


def test_decode_unaligned_cache():
    q, k, v = make_qkv(34, 1, 2, 1, 128, kv_seq=200)
    q = q[:, :, 0, :]
    lengths = jnp.array([200], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode unaligned cache")


def test_decode_head_dim_64():
    q, k, v = make_qkv(35, 1, 2, 1, 64, kv_seq=256)
    q = q[:, :, 0, :]
    lengths = jnp.array([256], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode head_dim=64")


def test_decode_head_dim_64_unpadded():
    """d64_unpadded keeps the cache 64-wide through the kernel (no per-step
    whole-cache pad copy); must match the padded path and the oracle."""
    q, k, v = make_qkv(36, 2, 4, 1, 64, num_kv_heads=2, kv_seq=384)
    q = q[:, :, 0, :]
    lengths = jnp.array([384, 200], jnp.int32)
    got = decode_attention(q, k, v, lengths, block_kv=128, d64_unpadded=True)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode d64 unpadded")
    padded = decode_attention(q, k, v, lengths, block_kv=128)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(padded, np.float32), atol=2e-2
    )


def test_decode_rejects_nonpositive_window():
    """sliding_window=0 would fully mask the live block and the plain-softmax
    epilogue would emit an unweighted average of arbitrary V rows — reject
    like the forward does."""
    q, k, v = make_qkv(37, 1, 2, 1, 128, kv_seq=256)
    q = q[:, :, 0, :]
    lengths = jnp.array([200], jnp.int32)
    for w in (0, -3):
        with pytest.raises(ValueError, match="sliding_window"):
            decode_attention(q, k, v, lengths, sliding_window=w)


def test_decode_non_dividing_default_block():
    """max_seq=6144: the default 4096 block must step down to a divisor
    (3072) instead of pad-copying the whole cache to 8192 per step."""
    from flash_attention_tpu.ops.tuning import select_decode_block_sizes

    assert 6144 % select_decode_block_sizes(6144).block_kv == 0
    q, k, v = make_qkv(38, 1, 2, 1, 128, kv_seq=768)
    q = q[:, :, 0, :]
    lengths = jnp.array([700], jnp.int32)
    # 768 with an explicit non-dividing 512 block: stepped down internally.
    got = decode_attention(q, k, v, lengths, block_kv=512)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="decode non-dividing block")


def test_decode_residuals_match_reference_lse():
    from flash_attention_tpu.ops.reference import reference_attention_with_lse

    q, k, v = make_qkv(36, 1, 2, 1, 128, kv_seq=256)
    q = q[:, :, 0, :]
    lengths = jnp.array([256], jnp.int32)
    got, lse2 = decode_attention(q, k, v, lengths, block_kv=128, save_residuals=True)
    want, want_lse2 = reference_attention_with_lse(q[:, :, None, :], k, v)
    assert_close(got, want[:, :, 0, :], msg="decode+lse out")
    np.testing.assert_allclose(
        np.asarray(lse2), np.asarray(want_lse2[:, :, 0]), atol=2e-2, rtol=1e-3
    )


@pytest.mark.parametrize("mode", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_decode_quantized_kv(mode):
    q, k, v = make_qkv(37, 2, 4, 1, 128, kv_seq=384)
    q = q[:, :, 0, :]
    lengths = jnp.array([384, 250], jnp.int32)
    kq, vq = quantize_kv(k, v, mode)
    got = decode_attention(q, kq, vq, lengths, block_kv=128)
    # Judge against the oracle running on the DEQUANTIZED cache (isolates the
    # kernel's fused-dequant correctness from the quantization error itself)…
    want_dq = _decode_oracle(
        q, dequantize(kq, k.dtype), dequantize(vq, v.dtype), lengths
    )
    assert_close(got, want_dq, tolerance=0.02, msg=f"fused dequant {mode}")
    # …and against the fp16-class oracle within the reference tolerance
    # (quantization error stays within the 0.1 bar for U(-0.5,0.5) inputs).
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg=f"end-to-end {mode}")


@pytest.mark.parametrize("num_splits", [2, 4])
def test_decode_split_merge(num_splits):
    q, k, v = make_qkv(38, 2, 4, 1, 128, kv_seq=512)
    q = q[:, :, 0, :]
    lengths = jnp.array([512, 200], jnp.int32)
    got = decode_attention_split(q, k, v, lengths, num_splits=num_splits, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg=f"flash-decoding x{num_splits}")


def test_decode_split_merge_quantized():
    q, k, v = make_qkv(39, 1, 4, 1, 128, kv_seq=512)
    q = q[:, :, 0, :]
    lengths = jnp.array([450], jnp.int32)
    kq, vq = quantize_kv(k, v, "int8")
    got = decode_attention_split(q, kq, vq, lengths, num_splits=4, block_kv=128)
    want = _decode_oracle(q, k, v, lengths)
    assert_close(got, want, msg="flash-decoding int8")


def test_should_split_decode_gate():
    from flash_attention_tpu.ops.decode import should_split_decode

    # Fires: small batch x kv_heads, long context.
    assert should_split_decode(1, 8, 16384, 4096) > 1
    assert should_split_decode(2, 8, 16384, 4096) > 1
    # Silent: big batch or short context.
    assert should_split_decode(32, 8, 8192, 4096) == 0
    assert should_split_decode(1, 8, 4096, 4096) == 0
    assert should_split_decode(4, 8, 8192, 4096) == 0  # b*kvh = 32 > 16


def test_decode_auto_split_matches_plain():
    """The auto-dispatched flash-decoding path is numerics-equivalent."""
    import jax.numpy as jnp

    from flash_attention_tpu.ops.decode import decode_attention

    q, k, v = make_qkv(21, 1, 8, 1, 128, num_kv_heads=2, kv_seq=8192)
    q = q[:, :, 0, :]
    lengths = jnp.asarray([7000], jnp.int32)
    auto = decode_attention(q, k, v, lengths, auto_split=True)  # gate fires
    plain = decode_attention(q, k, v, lengths, auto_split=False)
    np.testing.assert_allclose(
        np.asarray(auto, np.float32), np.asarray(plain, np.float32),
        rtol=2e-2, atol=2e-2,
    )


@pytest.mark.parametrize("mode", ["fp8_e4m3", "fp8_e5m2"])
def test_decode_quantized_window_softcap(mode):
    """fp8 takes the SIMD-packed widen: its pair-split position iota must
    reproduce the window mask exactly (judge = dense bf16 kernel on the
    dequantized cache, which uses the natural iota)."""
    q, k, v = make_qkv(41, 2, 4, 1, 128, kv_seq=384)
    q = q[:, :, 0, :]
    lengths = jnp.array([384, 251], jnp.int32)
    kq, vq = quantize_kv(k, v, mode)
    kd, vd = dequantize(kq, k.dtype), dequantize(vq, v.dtype)
    for kwargs in ({"sliding_window": 100}, {"logit_softcap": 30.0}):
        got = decode_attention(q, kq, vq, lengths, block_kv=128, **kwargs)
        want = decode_attention(q, kd, vd, lengths, block_kv=128, **kwargs)
        assert_close(got, want, tolerance=0.02, msg=f"packed {mode} {kwargs}")


@pytest.mark.parametrize("mode", ["fp8_e4m3", "fp8_e5m2"])
def test_native_fp8_dequant_matches_quant_dequantize(mode):
    """The paged decode kernel widens fp8 payloads with a plain in-kernel
    ``astype`` (Hopper converts fp8 natively). Over a one-token cache the
    output IS the dequantized V row, so it must equal ops/quant.dequantize
    of the same payload and scale to bf16 rounding."""
    from flash_attention_tpu.ops.paged import (
        init_paged_cache, paged_decode_attention, paged_write_tokens,
    )

    rng = np.random.default_rng(7)
    k = jnp.asarray(rng.uniform(-2.0, 2.0, (2, 2, 128)), jnp.bfloat16)
    v = jnp.asarray(rng.uniform(-2.0, 2.0, (2, 2, 128)), jnp.bfloat16)
    cache = init_paged_cache(
        num_pages=4, num_slots=2, pages_per_slot=2, kv_heads=2,
        page_size=128, kv_quant=mode,
    )
    cache = cache._replace(page_table=jnp.asarray([[3, 1], [0, 2]], jnp.int32))
    cache = paged_write_tokens(cache, k, v, jnp.arange(2))
    q = jnp.asarray(rng.uniform(-0.5, 0.5, (2, 4, 128)), jnp.bfloat16)
    got = paged_decode_attention(q, cache)
    _, vq = quantize_kv(k[:, :, None, :], v[:, :, None, :], mode)
    want = dequantize(vq, jnp.float32)[:, :, 0, :]  # [slots, kv_heads, D]
    want = jnp.repeat(want, 2, axis=1)  # GQA group of 2
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want), rtol=1e-2, atol=1e-2
    )


def test_rejects_misaligned_block_kv():
    """A non-128-multiple block_kv override must raise, not hang the
    divisor walk (which steps by 128) at trace time."""
    q, k, v = make_qkv(3, 2, 4, 1, 128, kv_seq=256)
    lengths = jnp.full((2,), 256, jnp.int32)
    with pytest.raises(ValueError, match="block_kv"):
        decode_attention(q[:, :, 0, :], k, v, lengths, block_kv=100)
    with pytest.raises(ValueError, match="block_kv"):
        decode_attention(q[:, :, 0, :], k, v, lengths, block_kv=-128)


@pytest.mark.parametrize("mode", ["fp8_e4m3", "fp8_e5m2"])
def test_fp8_decode_odd_divisor_cache(mode):
    """max_seq = 4224 = 128*33: every 128-multiple divisor is an ODD
    multiple of 128 (128*{1,3,11,33}), so the SIMD-packed widen's halved
    scale block would be lane-misaligned — the dispatch must fall back to
    the unpacked widen and stay correct."""
    q, k, v = make_qkv(41, 1, 2, 1, 128, kv_seq=4224)
    q = q[:, :, 0, :]
    lengths = jnp.array([4000], jnp.int32)
    kq, vq = quantize_kv(k, v, mode)
    got = decode_attention(q, kq, vq, lengths)
    want = _decode_oracle(
        q, dequantize(kq, k.dtype), dequantize(vq, v.dtype), lengths
    )
    assert_close(got, want, tolerance=0.02, msg=f"odd-divisor {mode}")
