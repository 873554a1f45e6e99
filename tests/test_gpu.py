"""Compiled kernels on the card (skipped without a GPU).

Run them there with: FA_TEST_PLATFORM=gpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.utils.testing import assert_close, make_qkv

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("causal", [False, True])
def test_compiled_forward_matches_reference(gpu, causal):
    q, k, v = make_qkv(0, 1, 8, 1024, 128, num_kv_heads=2)
    got = flash_attention(q, k, v, causal=causal, interpret=False)
    with jax.default_matmul_precision("highest"):
        want = reference_attention(q, k, v, causal=causal)
    assert_close(got, want)


def test_compiled_packed_causal_grad_runs(gpu):
    """The packed causal kernels (unpipelined on purpose) complete and
    match the reference gradient."""
    q, k, v = make_qkv(1, 1, 2, 1024, 128)
    seg = jnp.repeat(jnp.arange(4, dtype=jnp.int32), 256)[None]

    def grads(f):
        return jax.grad(lambda q, k, v: jnp.sum(
            f(q, k, v, causal=True, segment_ids=seg).astype(jnp.float32)),
            argnums=(0, 1, 2))(q, k, v)

    got = grads(lambda *a, **kw: flash_attention(*a, interpret=False, **kw))
    with jax.default_matmul_precision("highest"):
        want = grads(reference_attention)
    for g, w in zip(got, want):
        scale = float(jnp.max(jnp.abs(w)))
        np.testing.assert_allclose(
            np.asarray(g, np.float32), np.asarray(w, np.float32),
            atol=0.02 * scale,
        )


def test_compiled_paged_decode_matches_reference(gpu):
    from tests.test_paged import build_scattered_cache

    lengths = np.array([512, 200, 37], np.int32)
    cache, k, v = build_scattered_cache(0, 3, 2, lengths, 4)
    q = make_qkv(7, 3, 8, 1, 128)[0][:, :, 0, :]
    from flash_attention_tpu.ops.paged import paged_decode_attention

    got = paged_decode_attention(q, cache, interpret=False)
    with jax.default_matmul_precision("highest"):
        want = reference_attention(
            q[:, :, None, :], k, v, kv_length=jnp.asarray(lengths)
        )[:, :, 0, :]
    assert_close(got, want)
