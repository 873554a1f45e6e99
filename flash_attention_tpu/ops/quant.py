"""KV-cache quantization: int8 / fp8 payload with per-token fp32 scales.

The reference is fp16-only; the north-star (BASELINE.json) extends to
FP8/INT8 KV-cache decode with dequantization fused into the attention
matmuls. Storage layout: payload [B, H, S, D] in int8 or fp8, scales
[B, H, S, 1] fp32 (per token per head — one scale per cached K/V row, the
granularity that keeps dequant a single broadcast multiply inside the
kernel's KV tile).

Decode HBM traffic is dominated by the KV cache read; int8/fp8 halve it vs
bf16, which translates ~1:1 into decode throughput at long context.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class QuantizedTensor(NamedTuple):
    """Quantized payload + broadcastable scales (registered pytree)."""

    values: jax.Array  # [..., S, D] int8 / float8
    scales: jax.Array  # [..., S, 1] float32

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


def quantize_int8(x: jax.Array, *, axis: int = -1) -> QuantizedTensor:
    """Symmetric per-row int8 quantization (scale = absmax/127 over `axis`)."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=axis, keepdims=True)
    scale = jnp.where(absmax == 0.0, 1.0, absmax / 127.0)
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(values=q, scales=scale)


def quantize_fp8(
    x: jax.Array, *, axis: int = -1, dtype=jnp.float8_e4m3fn
) -> QuantizedTensor:
    """Per-row fp8 quantization: scale rows to the fp8 dynamic range."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=axis, keepdims=True)
    fp8_max = float(jnp.finfo(dtype).max)
    scale = jnp.where(absmax == 0.0, 1.0, absmax / fp8_max)
    q = (xf / scale).astype(dtype)
    return QuantizedTensor(values=q, scales=scale)


def dequantize(qt: QuantizedTensor, dtype=jnp.float32) -> jax.Array:
    return (qt.values.astype(jnp.float32) * qt.scales).astype(dtype)


def quantize_kv(k: jax.Array, v: jax.Array, mode: str):
    """Quantize K/V caches. mode in {'int8', 'fp8_e4m3', 'fp8_e5m2', 'none'}."""
    payload = payload_dtype(mode)
    if payload is None:
        return k, v
    return quantize_values(k, payload), quantize_values(v, payload)

def payload_dtype(mode: str):
    """Storage dtype for a KV quant mode; None for mode 'none'.

    The single source of truth for the mode -> dtype mapping (cache
    initializers and writers in models/attention.py and ops/paged.py all
    key off this instead of repeating the if/elif ladder).
    """
    if mode == "int8":
        return jnp.int8
    if mode == "fp8_e4m3":
        return jnp.float8_e4m3fn
    if mode == "fp8_e5m2":
        return jnp.float8_e5m2
    if mode == "none":
        return None
    raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_values(x: jax.Array, payload) -> QuantizedTensor:
    """Per-token quantization to an explicit payload dtype."""
    if payload == jnp.int8:
        return quantize_int8(x)
    return quantize_fp8(x, dtype=payload)



def quantize_weight(w: jax.Array, *, contract_axes) -> QuantizedTensor:
    """Weight-only symmetric int8 (W8A16), per OUTPUT channel.

    Serving weights are HBM-bandwidth-bound at decode batch sizes (the
    matmul reads the whole matrix once per step); storing them int8 with a
    per-output-channel fp32 scale halves the stream, and XLA fuses the
    `int8 -> bf16 * scale` widening into the matmul's weight read (the
    activations stay lossless; the gain on the H100 is not measured yet).

    contract_axes: the axes the matmul contracts over (per-channel scale
    spans the remaining output axes; scales keep rank with size-1
    contract dims, so `values.astype(bf16) * scales` broadcasts).
    """
    axes = tuple(
        a % w.ndim for a in (
            contract_axes if isinstance(contract_axes, (tuple, list))
            else (contract_axes,)
        )
    )
    xf = w.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=axes, keepdims=True)
    scale = jnp.where(absmax == 0.0, 1.0, absmax / 127.0)
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return QuantizedTensor(values=q, scales=scale)


def w8_dequant(w, dtype=jnp.bfloat16):
    """Array or QuantizedTensor -> compute-dtype weight (the fused form)."""
    if isinstance(w, QuantizedTensor):
        return (w.values.astype(dtype) * w.scales.astype(dtype)).astype(dtype)
    return w
