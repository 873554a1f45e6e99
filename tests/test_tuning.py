"""Tile-choice contracts (ops/tuning.py).

The tiles are derived from shape; these tests pin what every returned
choice must satisfy on Hopper under Triton — power-of-two tiles of at least
16 rows, no tile larger than the (padded) sequence it covers, and a staged
shared-memory footprint within the 227 KB a block may use — for head_dim 64
and 128. Each case also traces the public op and checks that its kernels
launch that choice whatever the mask, the GQA grouping or the outputs.
"""

import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

from flash_attention_tpu.ops.common import next_pow2
from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.tuning import (
    SMEM_BUDGET,
    BlockSizes,
    bwd_smem_bytes,
    fwd_smem_bytes,
    select_block_sizes,
    select_bwd_block_sizes,
)

HEADS = 8


def _is_pow2(x):
    return x >= 16 and x & (x - 1) == 0


def _assert_launchable(bs, q_len, kv_len):
    assert _is_pow2(bs.block_q) and _is_pow2(bs.block_kv), bs
    assert bs.block_q <= max(16, next_pow2(q_len)), bs
    assert bs.block_kv <= max(16, next_pow2(kv_len)), bs
    assert bs.num_warps in (1, 2, 4, 8, 16) and bs.num_stages >= 1, bs


def _launches(fn, *args):
    """{kernel name: (grid, rows of its first block, warps, stages)} of every
    pallas_call ``fn`` traces (shapes only; nothing runs)."""
    found = {}

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "pallas_call":
                gm = eqn.params["grid_mapping"]
                rows = gm.block_mappings[0].block_shape[1].block_size
                tp = eqn.params["compiler_params"]["triton"]
                found[eqn.params["name"]] = (
                    tuple(gm.grid), rows, tp.num_warps, tp.num_stages
                )
            for p in eqn.params.values():
                for sub in p if isinstance(p, (tuple, list)) else (p,):
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _qkv(q_len, kv_len, head_dim, group):
    q = jax.ShapeDtypeStruct((1, HEADS, q_len, head_dim), jnp.bfloat16)
    k = jax.ShapeDtypeStruct((1, HEADS // group, kv_len, head_dim), jnp.bfloat16)
    return q, k, k


def _grid(rows, tile):
    return (HEADS, -(-rows // tile))


@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_chunked_prefill_tier_head_batch_spans_groups(group):
    """The kv_seq >> q shape (chunked prefill / cross attention): the Q tile
    fits the chunk, the KV step the cache, and GQA grouping (an index map,
    not a tile dimension) changes neither."""
    for head_dim in (64, 128):
        bs = select_block_sizes(256, kv_seq=4096, head_dim=head_dim)
        _assert_launchable(bs, 256, 4096)
        assert fwd_smem_bytes(bs, head_dim) <= SMEM_BUDGET
        got = _launches(
            lambda q, k, v: flash_attention(q, k, v, causal=True, interpret=True),
            *_qkv(256, 4096, head_dim, group),
        )
        assert got == {"flash_attention_fwd": (
            _grid(256, bs.block_q), bs.block_q, bs.num_warps, bs.num_stages
        )}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("seq", [128, 512, 768, 1024, 2048, 4096, 8192, 16384])
@pytest.mark.parametrize("save_residuals", [False, True])
def test_forward_configs_are_well_formed(causal, group, seq, save_residuals):
    for head_dim in (64, 128):
        bs = select_block_sizes(seq, kv_seq=seq, head_dim=head_dim)
        _assert_launchable(bs, seq, seq)
        assert fwd_smem_bytes(bs, head_dim) <= SMEM_BUDGET, (bs, head_dim)
        got = _launches(
            lambda q, k, v: flash_attention(
                q, k, v, causal=causal, save_residuals=save_residuals,
                interpret=True,
            ),
            *_qkv(seq, seq, head_dim, group),
        )
        assert got == {"flash_attention_fwd": (
            _grid(seq, bs.block_q), bs.block_q, bs.num_warps, bs.num_stages
        )}, (bs, head_dim)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seq", [256, 2048, 4096, 8192])
def test_bwd_configs_are_well_formed(causal, seq):
    for head_dim in (64, 128):
        bs = select_bwd_block_sizes(seq, kv_seq=seq, head_dim=head_dim)
        _assert_launchable(bs, seq, seq)
        assert bwd_smem_bytes(bs, head_dim) <= SMEM_BUDGET, (bs, head_dim)

        def loss(q, k, v):
            o = flash_attention(q, k, v, causal=causal, interpret=True)
            return jnp.sum(o.astype(jnp.float32))

        got = _launches(
            jax.grad(loss, argnums=(0, 1, 2)), *_qkv(seq, seq, head_dim, 2)
        )
        launch = (bs.num_warps, bs.num_stages)
        assert got["flash_attention_bwd_dq"] == (
            _grid(seq, bs.block_q), bs.block_q, *launch
        ), (bs, head_dim)
        # dkv: one program per (KV head, KV tile).
        assert got["flash_attention_bwd_dkv"] == (
            (HEADS // 2, -(-seq // bs.block_kv)), bs.block_kv, *launch
        ), (bs, head_dim)


@pytest.mark.parametrize("causal", [False, True])
def test_packed_kernels_launch_the_selected_tiles(causal):
    """Packed inputs change the masks and the per-tile live ranges, never
    the launch: the forward and both backward kernels run the tiles and
    pipeline depth they are given."""
    fwd_bs, bwd_bs = BlockSizes(128, 64, 4, 3), BlockSizes(32, 64, 2, 2)
    q, k, v = _qkv(512, 512, 128, 1)
    seg = jax.ShapeDtypeStruct((1, 512), jnp.int32)

    def loss(q, k, v, seg):
        o = flash_attention(q, k, v, causal=causal, segment_ids=seg,
                            block_sizes=fwd_bs, bwd_block_sizes=bwd_bs,
                            interpret=True)
        return jnp.sum(o.astype(jnp.float32))

    got = _launches(jax.grad(loss, argnums=(0, 1, 2)), q, k, v, seg)
    assert got == {
        "flash_attention_fwd": (_grid(512, 128), 128, 4, 3),
        "flash_attention_bwd_dq": (_grid(512, 32), 32, 2, 2),
        "flash_attention_bwd_dkv": (_grid(512, 64), 64, 2, 2),
    }
