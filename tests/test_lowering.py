"""Every kernel lowers to Triton IR for CUDA.

The interpret-mode tests check the kernels' arithmetic; these check, on a
host without a GPU, that each kernel also goes through the Triton lowering
(every primitive has a GPU rule, block shapes are powers of two, scalar
loads are legal). What only the GPU compiler can refuse (shared memory,
registers) is left to the ``gpu`` tests and chip_smoke.py.
"""

import types

import jax
import jax.numpy as jnp
import pytest

from flash_attention_tpu.ops import common
from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.paged import init_paged_cache, paged_decode_attention

S = jax.ShapeDtypeStruct


@pytest.fixture
def as_if_gpu(monkeypatch):
    """Let the kernels' launch check see a GPU backend while they are only
    traced and lowered here; nothing traced under it is executed."""
    monkeypatch.setattr(
        common, "jax", types.SimpleNamespace(default_backend=lambda: "gpu")
    )


def triton_calls(fn, *args) -> int:
    text = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    return text.count("__gpu$xla.gpu.triton")


@pytest.mark.parametrize(
    "kw",
    [
        dict(causal=True),
        dict(causal=False),
        dict(causal=True, sliding_window=100, logit_softcap=30.0),
        dict(causal=True, packed=True),
    ],
    ids=["causal", "non-causal", "window-softcap", "packed"],
)
def test_forward_and_backward_lower_for_cuda(kw, as_if_gpu):
    kw = dict(kw)
    seg = S((1, 512), jnp.int32) if kw.pop("packed", False) else None
    q = S((1, 4, 512, 128), jnp.bfloat16)
    k = S((1, 2, 512, 128), jnp.bfloat16)

    def fwd(q, k, v, s):
        return flash_attention(q, k, v, segment_ids=s, interpret=False, **kw)

    def grad(q, k, v, s):
        return jax.grad(
            lambda q, k, v: jnp.sum(fwd(q, k, v, s).astype(jnp.float32)),
            argnums=(0, 1, 2),
        )(q, k, v)

    assert triton_calls(fwd, q, k, k, seg) == 1
    assert triton_calls(grad, q, k, k, seg) == 3  # fwd + dq + dkv


@pytest.mark.parametrize("mode", ["none", "int8", "fp8_e4m3", "fp8_e5m2"])
def test_paged_decode_lowers_for_cuda(mode, as_if_gpu):
    cache = init_paged_cache(
        num_pages=9, num_slots=3, pages_per_slot=3, kv_heads=2,
        page_size=256, kv_quant=mode,
    )
    cache = jax.tree_util.tree_map(lambda x: S(x.shape, x.dtype), cache)

    def fn(q, c):
        return paged_decode_attention(
            q, c, save_residuals=True, sliding_window=300, attention_sinks=4,
            logit_softcap=30.0, interpret=False,
        )

    assert triton_calls(fn, S((3, 8, 128), jnp.bfloat16), cache) == 1


def test_kernels_refuse_a_backend_without_gpu():
    """Without the interpret request, a kernel on a non-GPU backend raises
    an error naming the backend instead of silently interpreting."""
    q = jnp.zeros((1, 2, 128, 64), jnp.bfloat16)
    with pytest.raises(RuntimeError, match="'cpu'"):
        flash_attention(q, q, q, interpret=False)


@pytest.mark.parametrize(
    "hq,hkv,sq,skv,d",
    [(12, 4, 600, 600, 128), (6, 2, 300, 700, 96), (8, 8, 77, 77, 64)],
)
def test_ragged_shapes_lower_for_cuda(hq, hkv, sq, skv, d, as_if_gpu):
    """Non-power-of-two sequence lengths, head_dim 96 (padded to 128) and a
    GQA group of 3: padded operands, loads stay power-of-two tiles."""
    q = S((2, hq, sq, d), jnp.bfloat16)
    k = S((2, hkv, skv, d), jnp.bfloat16)

    def grad(q, k, v):
        return jax.grad(lambda q, k, v: jnp.sum(flash_attention(
            q, k, v, causal=True, interpret=False).astype(jnp.float32)),
            argnums=(0, 1, 2))(q, k, v)

    assert triton_calls(grad, q, k, k) == 3
