"""flash_attention_tpu — a flash-attention engine in JAX for NVIDIA Hopper.

Built in JAX/Pallas with the capabilities of the ``flash-attention-cuda``
reference (see SURVEY.md): a fused
QKᵀ → online-softmax → PV forward pass (causal + non-causal), fused backward
kernels (custom VJP), a shape-derived tile choice, split-KV partial
attention with log-sum-exp merge, quantized KV-cache decode, packed-sequence
attention with segment-aware block skipping, sliding-window attention with
O(window) rolling KV caches (dense ring buffer + paged ring), a
continuous-batching serving engine with a native C++ scheduler,
weight-only int8 (W8A16) model quantization for serving, and multi-chip
sharding over a ``jax.sharding.Mesh``.

Layout:
  ops/       Pallas kernels (Triton route) + pure-JAX oracle (the compute path)
  models/    attention / transformer modules built on the kernels
  parallel/  mesh, shard_map wrappers, ring attention
  serving/   continuous batching engine + scheduler wrapper
  native/    C++ runtime components (scheduler, oracle) via ctypes
  utils/     seeded test-input generation, diff checking, benchmarking
"""

from flash_attention_tpu.ops.reference import reference_attention
from flash_attention_tpu.ops.flash_attention import flash_attention
from flash_attention_tpu.ops.decode import decode_attention, decode_attention_split
from flash_attention_tpu.ops.merge import merge_partial_attention, merge_two
from flash_attention_tpu.ops.quant import (
    QuantizedTensor,
    quantize_kv,
    quantize_weight,
)
from flash_attention_tpu.ops.tuning import (
    BlockSizes,
    select_block_sizes,
    select_bwd_block_sizes,
)
from flash_attention_tpu.utils.checkpoint import load_kv_cache, save_kv_cache
from flash_attention_tpu.utils.distributed import (
    StepWatchdog,
    fail_fast,
    initialize_distributed,
)

__version__ = "0.6.0"

__all__ = [
    "reference_attention",
    "flash_attention",
    "decode_attention",
    "decode_attention_split",
    "quantize_weight",
    "merge_partial_attention",
    "merge_two",
    "QuantizedTensor",
    "quantize_kv",
    "BlockSizes",
    "select_block_sizes",
    "select_bwd_block_sizes",
    "save_kv_cache",
    "load_kv_cache",
    "initialize_distributed",
    "fail_fast",
    "StepWatchdog",
]
