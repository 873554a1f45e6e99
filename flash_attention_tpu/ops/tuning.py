"""Tile choice for the Triton-route kernels, derived from shape.

The reference picked BLOCK_M/BLOCK_N, warps and occupancy from four tiers
keyed on (causal, seq >= 2048) (flash_attention.cu:606-663). On Hopper the
same knobs exist under Triton: the Q tile held across the in-block KV loop
(``block_q``), the KV tile streamed through it (``block_kv``), the warps of
one program (``num_warps``) and the depth of the asynchronous K/V ring in
shared memory (``num_stages``). This module derives them from the problem
shape under three hardware rules:

  * Triton tiles are powers of two, and ``tl.dot`` wants every edge >= 16;
  * a tile never exceeds the (power-of-two padded) sequence it covers, so
    short sequences do not pad to a large tile;
  * the shared memory a program stages (the resident tile plus
    ``num_stages`` copies of the streamed tiles) stays within the 227 KB a
    Hopper block may use.
"""

from __future__ import annotations

import dataclasses

from flash_attention_tpu.ops.common import next_pow2

# Shared memory one Hopper thread block may use (H100 / H200).
SMEM_BUDGET = 227 * 1024
MIN_TILE = 16


@dataclasses.dataclass(frozen=True)
class BlockSizes:
    """Tile sizes and launch shape of one Triton-route attention kernel.

    block_q:  Q rows per program (the reference's BLOCK_M).
    block_kv: KV rows per inner-loop step (the reference's BLOCK_N).
    num_warps: warps per program.
    num_stages: software-pipeline depth of the streamed tiles.

    In the backward pass the dkv kernel holds a ``block_kv`` tile and loops
    over ``block_q`` tiles; the dq kernel holds ``block_q`` and loops over
    ``block_kv``.
    """

    block_q: int = 128
    block_kv: int = 64
    num_warps: int = 4
    num_stages: int = 3

    def __post_init__(self):
        for name in ("block_q", "block_kv"):
            b = getattr(self, name)
            if b < MIN_TILE or b & (b - 1):
                raise ValueError(
                    f"{name} must be a power of two >= {MIN_TILE}, got {self}"
                )
        if self.num_warps not in (1, 2, 4, 8, 16):
            raise ValueError(f"num_warps must be a power of two <= 16, got {self}")
        if self.num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {self}")


@dataclasses.dataclass(frozen=True)
class DecodeBlockSizes:
    """KV rows per split for dense-cache decode (the flash-decoding gate)."""

    block_kv: int = 4096


def clamp_to_seq(bs: BlockSizes, q_len: int, kv_len: int) -> BlockSizes:
    """Shrink a tile choice so no tile exceeds its padded sequence."""
    bq = max(MIN_TILE, min(bs.block_q, next_pow2(q_len)))
    bkv = max(MIN_TILE, min(bs.block_kv, next_pow2(kv_len)))
    if (bq, bkv) == (bs.block_q, bs.block_kv):
        return bs
    return dataclasses.replace(bs, block_q=bq, block_kv=bkv)


def fwd_smem_bytes(bs: BlockSizes, head_dim: int, itemsize: int = 2) -> int:
    """Shared memory the forward stages: the resident Q tile plus
    ``num_stages`` copies of one K and one V tile."""
    d = next_pow2(head_dim)
    return (bs.block_q + 2 * bs.num_stages * bs.block_kv) * d * itemsize


def bwd_smem_bytes(bs: BlockSizes, head_dim: int, itemsize: int = 2) -> int:
    """Upper bound over the two backward kernels: the dkv kernel keeps K and
    V resident and streams Q and dO; the dq kernel keeps Q and dO and
    streams K and V."""
    d = next_pow2(head_dim)
    dkv = (2 * bs.block_kv + 2 * bs.num_stages * bs.block_q) * d * itemsize
    dq = (2 * bs.block_q + 2 * bs.num_stages * bs.block_kv) * d * itemsize
    return max(dkv, dq)


def _fit(bs: BlockSizes, smem, head_dim: int) -> BlockSizes:
    while smem(bs, head_dim) > SMEM_BUDGET and bs.num_stages > 1:
        bs = dataclasses.replace(bs, num_stages=bs.num_stages - 1)
    while smem(bs, head_dim) > SMEM_BUDGET and bs.block_kv > MIN_TILE:
        bs = dataclasses.replace(bs, block_kv=bs.block_kv // 2)
    return bs


def select_block_sizes(
    seq: int, *, kv_seq: int | None = None, head_dim: int = 128
) -> BlockSizes:
    """Forward tiles for a ``seq``-row problem (``kv_seq`` KV rows).

    A 128-row Q tile with 64-row KV steps keeps the fp32 accumulator of a
    d=128 tile in registers at four warps; head_dim 64 affords 128-row KV
    steps. At d=128 a two-deep K/V ring beat a three-deep one on the H100
    on causal, non-causal, GQA and packed shapes. Causal masking, GQA
    grouping, windows, packed segments and the LSE output change only the
    masks and index maps, not the tiles.
    """
    kv_seq = seq if kv_seq is None else kv_seq
    if head_dim <= 64:
        bs = BlockSizes(block_q=128, block_kv=128, num_warps=4, num_stages=3)
    else:
        bs = BlockSizes(block_q=128, block_kv=64, num_warps=4, num_stages=2)
    return _fit(clamp_to_seq(bs, seq, kv_seq), fwd_smem_bytes, head_dim)


def select_bwd_block_sizes(
    seq: int, *, kv_seq: int | None = None, head_dim: int = 128
) -> BlockSizes:
    """Backward tiles: 64 x 64 at four warps and two stages. The backward
    keeps two resident tiles and two fp32 accumulators per program, so its
    tiles are half the forward's."""
    kv_seq = seq if kv_seq is None else kv_seq
    bs = BlockSizes(block_q=64, block_kv=64, num_warps=4, num_stages=2)
    return _fit(clamp_to_seq(bs, seq, kv_seq), bwd_smem_bytes, head_dim)


def select_decode_block_sizes(kv_seq: int) -> DecodeBlockSizes:
    """Largest 128-multiple divisor of the 128-padded cache length, capped
    at 4096 — the split unit :func:`ops.decode.should_split_decode` reasons
    about."""
    seq_pad = -(-kv_seq // 128) * 128
    bk = min(4096, seq_pad)
    while seq_pad % bk:
        bk -= 128
    return DecodeBlockSizes(block_kv=bk)
