"""LLaMA-class decoder-only transformer built on the attention engine.

The flagship serving model family for the north-star configs (7B-class,
32 q heads / 8 kv heads / head_dim 128). Functional pytree params; every
matmul shaped for the tensor cores (bf16 inputs, fp32 accumulation via
preferred_element_type); attention runs through the attention ops.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from flash_attention_tpu.models.attention import (
    AttentionConfig,
    KVCache,
    attention_decode,
    attention_decode_paged,
    attention_decode_paged_deferred,
    attention_forward,
    attention_prefill,
    attention_prefill_chunk,
    attention_prefill_chunk_paged,
    attention_prefill_paged,
    init_attention_params,
    init_kv_cache,
)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    model_dim: int = 4096
    num_layers: int = 32
    num_q_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    kv_quant: str = "none"
    # Weight-only int8 (W8A16): weights stored int8 + per-output-channel
    # fp32 scale (ops/quant.py::quantize_weight); matmuls widen in the
    # fused weight read. Decode is weight-read bound at serving batch
    # sizes, so this ~halves the non-attention step time. "none" | "int8".
    weight_quant: str = "none"
    dtype: str = "bfloat16"
    sliding_window: int | None = None
    logit_softcap: float | None = None
    rolling: bool = False  # O(window) ring-buffer KV cache (needs sliding_window)
    attention_sinks: int = 0  # StreamingLLM sinks (needs rolling)

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def attention_config(self) -> AttentionConfig:
        return AttentionConfig(
            model_dim=self.model_dim,
            num_q_heads=self.num_q_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim,
            rope_theta=self.rope_theta,
            kv_quant=self.kv_quant,
            dtype=self.dtype,
            sliding_window=self.sliding_window,
            logit_softcap=self.logit_softcap,
            rolling=self.rolling,
            attention_sinks=self.attention_sinks,
        )

    @staticmethod
    def tiny(**overrides) -> "ModelConfig":
        """A small config for tests / dryruns."""
        defaults = dict(
            vocab_size=256, model_dim=256, num_layers=2, num_q_heads=8,
            num_kv_heads=4, head_dim=32, mlp_dim=512,
        )
        defaults.update(overrides)
        return ModelConfig(**defaults)


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * weight.astype(jnp.float32)).astype(x.dtype)


def swiglu(x: jax.Array, params) -> jax.Array:
    from flash_attention_tpu.ops.quant import w8_dequant

    gate = jnp.einsum(
        "btm,mf->btf", x, w8_dequant(params["w_gate"]),
        preferred_element_type=jnp.float32,
    )
    up = jnp.einsum(
        "btm,mf->btf", x, w8_dequant(params["w_up"]),
        preferred_element_type=jnp.float32,
    )
    act = (jax.nn.silu(gate) * up).astype(x.dtype)
    return jnp.einsum(
        "btf,fm->btm", act, w8_dequant(params["w_down"]),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)


def init_model_params(key, cfg: ModelConfig):
    dt = cfg.jnp_dtype
    keys = jax.random.split(key, cfg.num_layers + 2)
    acfg = cfg.attention_config()

    def init_layer(k):
        ka, kg, ku, kd = jax.random.split(k, 4)
        s_in = 1.0 / math.sqrt(cfg.model_dim)
        s_mlp = 1.0 / math.sqrt(cfg.mlp_dim)
        return {
            "attn": init_attention_params(ka, acfg),
            "attn_norm": jnp.ones((cfg.model_dim,), dt),
            "mlp_norm": jnp.ones((cfg.model_dim,), dt),
            "mlp": {
                "w_gate": (jax.random.normal(kg, (cfg.model_dim, cfg.mlp_dim), jnp.float32) * s_in).astype(dt),
                "w_up": (jax.random.normal(ku, (cfg.model_dim, cfg.mlp_dim), jnp.float32) * s_in).astype(dt),
                "w_down": (jax.random.normal(kd, (cfg.mlp_dim, cfg.model_dim), jnp.float32) * s_mlp).astype(dt),
            },
        }

    params = {
        "embed": (
            jax.random.normal(keys[0], (cfg.vocab_size, cfg.model_dim), jnp.float32)
            / math.sqrt(cfg.model_dim)
        ).astype(dt),
        "layers": [init_layer(k) for k in keys[1:-1]],
        "final_norm": jnp.ones((cfg.model_dim,), dt),
    }
    if cfg.weight_quant == "int8":
        params = quantize_model_weights(params)
    elif cfg.weight_quant != "none":
        raise ValueError(f"unknown weight_quant {cfg.weight_quant!r}")
    return params


def quantize_model_weights(params):
    '''Weight-only int8 conversion of a bf16 parameter tree (W8A16).

    Matmul weights become QuantizedTensor (int8 payload + per-output-
    channel fp32 scale); norms stay bf16. The embedding quantizes per
    VOCAB ROW so the same payload serves lookups and the tied unembed.
    Apply to freshly-initialized or loaded params; every model entry
    point accepts the converted tree transparently (the einsum sites
    widen through ops/quant.py::w8_dequant).
    '''
    from flash_attention_tpu.ops.quant import quantize_weight

    def q_layer(lp):
        attn = dict(lp["attn"])
        for name, axes in (("wq", 0), ("wk", 0), ("wv", 0), ("wo", (0, 1))):
            attn[name] = quantize_weight(attn[name], contract_axes=axes)
        mlp = {
            "w_gate": quantize_weight(lp["mlp"]["w_gate"], contract_axes=0),
            "w_up": quantize_weight(lp["mlp"]["w_up"], contract_axes=0),
            "w_down": quantize_weight(lp["mlp"]["w_down"], contract_axes=0),
        }
        return {**lp, "attn": attn, "mlp": mlp}

    return {
        **params,
        "embed": quantize_weight(params["embed"], contract_axes=1),
        "layers": [q_layer(lp) for lp in params["layers"]],
    }


def init_caches(
    cfg: ModelConfig, batch: int, max_seq: int, *, prefill_chunk: int = 0
) -> list:
    acfg = cfg.attention_config()
    return [
        init_kv_cache(acfg, batch, max_seq, prefill_chunk=prefill_chunk)
        for _ in range(cfg.num_layers)
    ]


def _trunk(params, cfg: ModelConfig, tokens: jax.Array, attn_fn, caches=None):
    """Shared decoder trunk: embed -> N x (pre-norm attention via `attn_fn` +
    pre-norm SwiGLU, both residual) -> final norm -> tied-embedding logits.

    Every model entry point (training, prefill, chunked prefill, decode,
    paged variants) differs ONLY in the attention call, so that is the one
    injected piece: ``attn_fn(layer_attn_params, acfg, h, cache) ->
    (attn_out, new_cache)`` (cache is None end-to-end on the cache-free
    training path). Returns (logits [B, T, vocab], new_caches).
    """
    from flash_attention_tpu.ops.quant import QuantizedTensor

    acfg = cfg.attention_config()
    emb = params["embed"]
    if isinstance(emb, QuantizedTensor):
        # Per-vocab-row scales serve both directions: lookup rows widen
        # with their own scale; the tied unembed contracts over model_dim
        # with the scale landing on the output vocab axis.
        x = (
            emb.values[tokens].astype(cfg.jnp_dtype)
            * emb.scales[tokens].astype(cfg.jnp_dtype)
        )
    else:
        x = emb[tokens].astype(cfg.jnp_dtype)
    new_caches = []
    cache_list = [None] * len(params["layers"]) if caches is None else caches
    for lp, cache in zip(params["layers"], cache_list):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        attn_out, cache = attn_fn(lp["attn"], acfg, h, cache)
        x = x + attn_out
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        x = x + swiglu(h, lp["mlp"])
        new_caches.append(cache)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if isinstance(emb, QuantizedTensor):
        logits = jnp.einsum(
            "btm,vm->btv", x, emb.values.astype(cfg.jnp_dtype),
            preferred_element_type=jnp.float32,
        ) * emb.scales[:, 0].astype(jnp.float32)[None, None, :]
    else:
        logits = jnp.einsum(
            "btm,vm->btv", x, emb, preferred_element_type=jnp.float32
        )
    return logits, new_caches


def forward(params, cfg: ModelConfig, tokens: jax.Array, caches: list, *, decode: bool = False):
    """Run the model over [B, T] tokens (T=1 when decode=True).

    Returns (logits [B, T, vocab], updated caches).
    """
    attn = attention_decode if decode else attention_prefill
    return _trunk(params, cfg, tokens, attn, caches)


def prefill(params, cfg: ModelConfig, tokens: jax.Array, caches: list):
    return forward(params, cfg, tokens, caches, decode=False)


def segment_positions(segment_ids: jax.Array) -> jax.Array:
    """Per-document RoPE positions for a packed [B, T] segment-id array:
    positions restart at 0 at every segment boundary (ids are contiguous
    runs)."""
    t = segment_ids.shape[-1]
    idx = jnp.arange(t)[None, :]
    is_start = jnp.concatenate(
        [
            jnp.ones_like(segment_ids[:, :1], bool),
            segment_ids[:, 1:] != segment_ids[:, :-1],
        ],
        axis=1,
    )
    seg_start = jax.lax.cummax(jnp.where(is_start, idx, 0), axis=1)
    return idx - seg_start


def train_forward(
    params, cfg: ModelConfig, tokens: jax.Array, *, segment_ids=None
):
    """Training-mode forward (no KV caches): causal LM logits over [B, T]
    tokens. With ``segment_ids`` (packed pretraining batches), attention is
    masked per document and RoPE positions restart at each document start.
    Returns logits [B, T, vocab]; differentiate with jax.value_and_grad.
    """
    positions = None if segment_ids is None else segment_positions(segment_ids)

    def attn(p, acfg, h, cache):
        out = attention_forward(
            p, acfg, h, positions=positions, segment_ids=segment_ids
        )
        return out, cache

    logits, _ = _trunk(params, cfg, tokens, attn)
    return logits


def prefill_chunk(
    params, cfg: ModelConfig, tokens: jax.Array, caches: list, slot, start,
    kv_end: int,
):
    """Prefill ONE CHUNK ([1, T] tokens at positions [start, start+T)) of one
    sequence into its slot of the batched caches (start + T == kv_end, kv_end
    static). Returns (logits [1, T, vocab], updated caches) — chunked prefill
    lets long prompts interleave with decode steps instead of stalling them.
    """
    return _trunk(
        params, cfg, tokens,
        lambda p, acfg, h, c: attention_prefill_chunk(
            p, acfg, h, c, slot, start, kv_end
        ),
        caches,
    )


def decode_step_logits(params, cfg: ModelConfig, tokens: jax.Array, caches: list):
    """One decode step returning raw last-position logits [B, vocab] (the
    sampling layer chooses the token; see serving/sampling.py)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True)
    return logits[:, -1, :], caches


def init_paged_caches(
    cfg: ModelConfig, *, num_pages: int, num_slots: int, pages_per_slot: int,
    page_size: int = 128,
) -> list:
    from flash_attention_tpu.ops.paged import init_paged_cache

    return [
        init_paged_cache(
            num_pages=num_pages, num_slots=num_slots,
            pages_per_slot=pages_per_slot, kv_heads=cfg.num_kv_heads,
            page_size=page_size, head_dim=cfg.head_dim, dtype=cfg.jnp_dtype,
            kv_quant=cfg.kv_quant,
        )
        for _ in range(cfg.num_layers)
    ]


def prefill_paged(params, cfg: ModelConfig, tokens, caches, slot, true_len):
    """Prefill ONE sequence ([1, T] tokens, T a page multiple) into its slot's
    pages. Returns (logits [1, T, vocab], updated caches)."""
    return _trunk(
        params, cfg, tokens,
        lambda p, acfg, h, c: attention_prefill_paged(
            p, acfg, h, c, slot, true_len
        ),
        caches,
    )


def prefill_chunk_paged(
    params, cfg: ModelConfig, tokens, caches, slot, start, kv_end: int
):
    """Chunked prefill over paged caches: [1, T] tokens at positions
    [start, start+T), T a page multiple, start + T == kv_end (static).
    Returns (logits [1, T, vocab], updated caches)."""
    return _trunk(
        params, cfg, tokens,
        lambda p, acfg, h, c: attention_prefill_chunk_paged(
            p, acfg, h, c, slot, start, kv_end
        ),
        caches,
    )


def decode_step_logits_paged(params, cfg: ModelConfig, tokens, caches):
    """One paged decode step returning raw last-position logits [S, vocab].

    Uses the deferred-write path: every layer attends over the cache as-is
    with the current token's self term merged in at full precision
    (attention_decode_paged_deferred), and ALL layers' K/V tokens land in
    one paged_write_tokens_multi scatter after the layer stack instead of
    one write inside each layer. sliding_window <= 1 (degenerate) keeps the
    write-first path.
    """
    from flash_attention_tpu.ops.paged import paged_write_tokens_multi

    if cfg.sliding_window is not None and cfg.sliding_window <= 1:
        logits, new_caches = _trunk(
            params, cfg, tokens, attention_decode_paged, caches
        )
        return logits[:, -1, :], new_caches

    pending = []

    def attn(lp, acfg, h, cache):
        out, kv = attention_decode_paged_deferred(lp, acfg, h, cache)
        pending.append(kv)
        return out, cache

    logits, new_caches = _trunk(params, cfg, tokens, attn, caches)
    num_slots = tokens.shape[0]
    new_caches = paged_write_tokens_multi(
        new_caches,
        [kv[0] for kv in pending],
        [kv[1] for kv in pending],
        jnp.arange(num_slots),
    )
    return logits[:, -1, :], new_caches


def decode_step_paged(params, cfg: ModelConfig, tokens, caches):
    """One greedy decode step over all slots ([S, 1] tokens) against paged
    caches. Returns (next_tokens [S, 1], updated caches)."""
    logits, caches = decode_step_logits_paged(params, cfg, tokens, caches)
    return jnp.argmax(logits[:, None, :], axis=-1), caches


def decode_step(params, cfg: ModelConfig, tokens: jax.Array, caches: list):
    """One greedy decode step: tokens [B, 1] -> (next_tokens [B, 1], caches)."""
    logits, caches = forward(params, cfg, tokens, caches, decode=True)
    return jnp.argmax(logits[:, -1:, :], axis=-1), caches
