#!/usr/bin/env python3
"""Start the attention engine on an NVIDIA GPU and check it end to end.

    python3 chip_smoke.py               # one GPU: every kernel + the engine
    python3 chip_smoke.py --devices 4   # four GPUs: the multi-device paths

One GPU, three phases, each fatal on failure:

  1. device — JAX must report a GPU (there is no CPU fallback); the card's
     name and power limit are printed as nvidia-smi reports them;
  2. ops    — every kernel of the serving and training paths, compiled for
     the GPU, against the fp32 reference (ops/reference.py) at real widths;
  3. engine — PagedServingEngine with the full-width 32-layer default
     ModelConfig (random weights from a seed, int8 KV cache, 1024-token
     pages) serves 8 requests, and one request's prefill logits are checked
     against a plain forward built on the reference attention.

With ``--devices 4`` only the multi-device paths run, each against its
one-device result: head-sharded prefill attention and int8 decode through
the shard_map wrappers of parallel/sharding.py (each device holds its own
heads and the program has no collective), the dp x tp sharded prefill +
decode step at 7B widths (depth cut to 2 layers), and ring attention forward
and gradient, contiguous and zigzag, at sequence 4 x 4096.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# Output limit: the reference harness's bar, max |kernel - fp32 oracle| < 0.1
# for U(-0.5, 0.5) inputs (flash_attention.cu:784; utils/testing.py).
OUT_LIMIT = 0.1
# Gradient limit, relative to the largest reference gradient: the kernels
# emit bf16 gradients (8 significant bits, 0.4%) summed in another order than
# the fp32 reference; 2% leaves a 5x margin.
GRAD_REL_LIMIT = 0.02
# LSE limit (base-2 log-sum-exp, fp32 in the kernel; tests/test_paged.py).
LSE_LIMIT = 0.02
# Prefill-logit limit, relative to the largest reference logit: 32 bf16
# residual layers in both runs; they differ only in the attention (bf16 P
# tiles in the kernel, fp32 in the reference).
LOGIT_REL_LIMIT = 0.05


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Problem sizes of every phase (the defaults are the real ones)."""

    heads: int = 32
    head_dim: int = 128
    seq: int = 4096  # forward cases
    long_seq: int = 16384  # long causal and sliding-window forward
    window: int = 4096
    gqa_seq: int = 8192  # GQA forward and gradient, packed cases
    doc: int = 2048  # packed document length
    grad_seq: int = 2048
    ref_heads: int = 2  # reference heads where seq x seq scores are too big
    decode_batch: int = 32
    decode_seq: int = 8192
    page: int = 1024
    chunk: int = 1024  # paged prefill chunk
    engine_chunk: int = 2048  # the engine's prefill chunk
    engine_slots: int = 8
    engine_prompts: tuple = (1024, 1500, 2048, 2600, 3000, 3500, 3900, 4096)
    engine_pages_per_slot: int = 8
    new_tokens: int = 32
    mesh_layers: int = 2  # dp x tp step at 7B widths, depth cut
    mesh_prompt: int = 512
    ring_seq_per_device: int = 4096
    ring_heads: int = 8
    model: dict = dataclasses.field(default_factory=dict)  # ModelConfig fields

    def model_config(self, **overrides):
        from flash_attention_tpu.models.transformer import ModelConfig

        return ModelConfig(**{**self.model, **overrides})


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def max_diff(a, b) -> float:
    return float(jnp.max(jnp.abs(a.astype(jnp.float32) - b.astype(jnp.float32))))


def compare(name: str, got, want, limit: float = OUT_LIMIT) -> None:
    d = max_diff(got, want)
    log(f"  {name}: max_abs_diff={d:.6f} limit={limit}")
    check(bool(np.isfinite(d)) and d < limit, f"{name}: {d} >= {limit}")


def compare_rel(name: str, got, want, rel: float) -> None:
    d = max_diff(got, want)
    scale = float(jnp.max(jnp.abs(want.astype(jnp.float32))))
    limit = rel * scale
    log(f"  {name}: max_abs_diff={d:.6f} limit={limit:.6f} "
        f"({rel} x max|ref| {scale:.4f})")
    check(bool(np.isfinite(d)) and d <= limit, f"{name}: {d} > {limit}")


# ---------------------------------------------------------------- device --

def device_phase(want_devices: int) -> None:
    devices = jax.devices()
    platform = devices[0].platform
    check(platform == "gpu", f"JAX found platform {platform!r}, not a GPU")
    check(len(devices) >= want_devices,
          f"need {want_devices} GPUs, JAX found {len(devices)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=120,
    ).stdout.strip()
    for line in smi.splitlines():
        log(f"nvidia-smi: {line}")
    log(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")


# ------------------------------------------------------------------- ops --

def _ref(**kw):
    from flash_attention_tpu.ops.reference import reference_attention

    return jax.jit(functools.partial(reference_attention, **kw))


def _segments(seq, doc):
    if doc is None:
        return None
    return jnp.repeat(jnp.arange(seq // doc, dtype=jnp.int32), doc)[None]


def fwd_case(sz, name, *, seq, causal=True, dtype=jnp.bfloat16, group=1,
             head_dim=None, window=None, softcap=None, doc=None, ref_q=None):
    """Kernel over all query heads; fp32 reference over the first ``ref_q``
    heads (whole GQA groups) where seq x seq fp32 scores are too big."""
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.utils.testing import make_qkv

    h = sz.heads
    ref_q = ref_q or h
    q, k, v = make_qkv(1, 1, h, seq, head_dim or sz.head_dim,
                       num_kv_heads=h // group, dtype=dtype)
    kw = dict(causal=causal, sliding_window=window, logit_softcap=softcap,
              segment_ids=_segments(seq, doc))
    got = jax.jit(functools.partial(flash_attention, **kw))(q, k, v)
    ref_kv = ref_q // group
    with jax.default_matmul_precision("highest"):
        want = _ref(**kw)(
            q[:, :ref_q].astype(jnp.float32), k[:, :ref_kv].astype(jnp.float32),
            v[:, :ref_kv].astype(jnp.float32),
        )
    check(got.shape == q.shape and got.dtype == dtype, f"{name}: {got.shape}")
    compare(name, got[:, :ref_q], want)


def grad_case(sz, name, *, seq, group=1, doc=None, ref_q=None):
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.reference import reference_attention
    from flash_attention_tpu.utils.testing import make_qkv

    h = sz.heads
    ref_q = ref_q or h
    q, k, v = make_qkv(2, 1, h, seq, sz.head_dim, num_kv_heads=h // group)
    w = jax.random.normal(jax.random.key(3), q.shape, jnp.float32)
    seg = _segments(seq, doc)

    def loss(attn, w):
        return lambda q, k, v: jnp.sum(
            attn(q, k, v, causal=True, segment_ids=seg).astype(jnp.float32) * w
        )

    got = jax.jit(jax.grad(loss(flash_attention, w), argnums=(0, 1, 2)))(q, k, v)
    ref_kv = ref_q // group
    sub = (q[:, :ref_q], k[:, :ref_kv], v[:, :ref_kv])
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(
            loss(reference_attention, w[:, :ref_q]), argnums=(0, 1, 2)
        ))(*(x.astype(jnp.float32) for x in sub))
    for g, wnt, part, n in zip(got, want, "qkv", (ref_q, ref_kv, ref_kv)):
        check(bool(jnp.all(jnp.isfinite(g.astype(jnp.float32)))),
              f"{name} d{part} not finite")
        compare_rel(f"{name} d{part}", g[:, :n], wnt, GRAD_REL_LIMIT)


@jax.jit
def _ref_decode(q, k, v, lengths):
    from flash_attention_tpu.ops.reference import reference_attention_with_lse

    with jax.default_matmul_precision("highest"):
        o, lse = reference_attention_with_lse(
            q.astype(jnp.float32)[:, :, None, :], k, v, kv_length=lengths
        )
    return o[:, :, 0], lse[:, :, 0]


def decode_cases(sz):
    from flash_attention_tpu.ops.decode import decode_attention
    from flash_attention_tpu.ops.quant import QuantizedTensor, dequantize, quantize_kv
    from flash_attention_tpu.utils.testing import make_qkv

    b, seq, hkv = sz.decode_batch, sz.decode_seq, sz.heads // 4
    q, k, v = make_qkv(4, b, sz.heads, 1, sz.head_dim, num_kv_heads=hkv,
                       kv_seq=seq)
    q = q[:, :, 0, :]
    lengths = jax.random.randint(jax.random.key(5), (b,), 1, seq + 1)
    lengths = lengths.at[0].set(seq).astype(jnp.int32)
    for mode in ("none", "int8", "fp8_e4m3", "fp8_e5m2"):
        kq, vq = quantize_kv(k, v, mode)
        got = jax.jit(decode_attention)(q, kq, vq, lengths)
        deq = [dequantize(x, jnp.float32) if isinstance(x, QuantizedTensor)
               else x.astype(jnp.float32) for x in (kq, vq)]
        want, _ = _ref_decode(q, *deq, lengths)
        compare(f"dense decode b={b} s={seq} {sz.heads}/{hkv} kv={mode}",
                got, want)


def paged_cases(sz):
    """int8 paged cache: prefill writes, paged decode with residuals, one
    prefill chunk over the pages, single-token writes."""
    from flash_attention_tpu.ops.paged import (
        _quantize_rows,
        init_paged_cache,
        paged_decode_attention,
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
        paged_write_tokens,
    )
    from flash_attention_tpu.utils.testing import make_qkv

    slots, seq, page, hkv = sz.decode_batch, sz.decode_seq, sz.page, sz.heads // 4
    pps = seq // page
    cache = init_paged_cache(
        num_pages=slots * pps + 1, num_slots=slots, pages_per_slot=pps,
        kv_heads=hkv, page_size=page, head_dim=sz.head_dim, kv_quant="int8",
    )
    perm = 1 + jax.random.permutation(jax.random.key(6), slots * pps)
    cache = cache._replace(page_table=perm.reshape(slots, pps).astype(jnp.int32))
    _, k, v = make_qkv(7, slots, hkv, 1, sz.head_dim, kv_seq=seq)
    write = jax.jit(paged_write_prefill, donate_argnums=(0,))
    for s in range(slots):
        cache = write(cache, k[s], v[s], s, seq)
    lengths = jax.random.randint(jax.random.key(8), (slots,), 1, seq + 1)
    lengths = lengths.at[0].set(seq).astype(jnp.int32)
    cache = cache._replace(lengths=lengths)

    gather = jax.jit(jax.vmap(lambda c, s: paged_gather_kv(
        c, s, seq, dtype=jnp.float32), in_axes=(None, 0)))
    k_deq, v_deq = (x[:, 0] for x in gather(cache, jnp.arange(slots)))
    # int8 per-token absmax quantization of U(-0.5, 0.5): half a step is at
    # most 0.5 / 127 / 2 = 0.00197.
    compare("paged write_prefill int8 round trip", k_deq, k, 0.0025)

    q = make_qkv(9, slots, sz.heads, 1, sz.head_dim)[0][:, :, 0, :]
    o, lse = jax.jit(functools.partial(
        paged_decode_attention, save_residuals=True))(q, cache)
    want_o, want_lse = _ref_decode(q, k_deq, v_deq, lengths)
    compare(f"paged decode int8 b={slots} s={seq} page={page} out", o, want_o)
    compare("paged decode residual lse2", lse, want_lse, LSE_LIMIT)

    chunk = sz.chunk
    qc = make_qkv(10, 1, sz.heads, chunk, sz.head_dim)[0]
    got = paged_prefill_attention(qc, cache, 0, seq, chunk_len=chunk)
    with jax.default_matmul_precision("highest"):
        want = _ref(causal=True)(qc.astype(jnp.float32), k_deq[:1], v_deq[:1])
    compare(f"paged prefill chunk {chunk} at kv_end {seq}", got, want)

    # Single-token writes for every slot, each below capacity.
    cache = cache._replace(lengths=jnp.minimum(lengths, seq - 1))
    _, k1, v1 = make_qkv(11, slots, hkv, 1, sz.head_dim)
    k1, v1 = k1[:, :, 0], v1[:, :, 0]
    before = np.asarray(cache.lengths)
    new = jax.jit(paged_write_tokens)(cache, k1, v1, jnp.arange(slots))
    phys = np.asarray(cache.page_table)[np.arange(slots), before // page]
    want_q, want_s = jax.vmap(lambda x: _quantize_rows(x, jnp.int8))(k1)
    check(bool(jnp.all(new.k_pages[phys, :, before % page, :] == want_q)),
          "paged write_tokens payload")
    check(bool(jnp.all(
        new.k_scales[phys, :, 0, before % page] == want_s[..., 0])),
        "paged write_tokens scales")
    check(bool(jnp.all(new.lengths == before + 1)), "paged write_tokens lengths")
    log(f"  paged write_tokens int8 x{slots}: payload, scales and lengths exact")


def ops_phase(sz: Sizes) -> None:
    log("ops: kernels compiled for the GPU vs the fp32 reference")
    h, r = sz.heads, sz.ref_heads
    fwd_case(sz, f"fwd bf16 b1 h{h} d{sz.head_dim} causal {sz.seq}", seq=sz.seq)
    fwd_case(sz, f"fwd bf16 non-causal {sz.seq}", seq=sz.seq, causal=False)
    fwd_case(sz, f"fwd bf16 causal {sz.long_seq} (ref heads 0-{r - 1})",
             seq=sz.long_seq, ref_q=r)
    fwd_case(sz, f"fwd fp16 causal {sz.seq}", seq=sz.seq, dtype=jnp.float16)
    fwd_case(sz, f"fwd GQA {h}/{h // 4} causal {sz.gqa_seq} (ref heads 0-3)",
             seq=sz.gqa_seq, group=4, ref_q=4)
    fwd_case(sz, f"fwd window {sz.window} causal {sz.long_seq} "
             f"(ref heads 0-{r - 1})", seq=sz.long_seq, window=sz.window,
             ref_q=r)
    fwd_case(sz, f"fwd softcap 50 causal {sz.seq}", seq=sz.seq, softcap=50.0)
    n_docs = sz.gqa_seq // sz.doc
    fwd_case(sz, f"fwd packed {n_docs}x{sz.doc} causal {sz.gqa_seq} "
             "(ref heads 0-3)", seq=sz.gqa_seq, doc=sz.doc, ref_q=4)
    fwd_case(sz, f"fwd d64 causal {sz.seq}", seq=sz.seq, head_dim=64)
    grad_case(sz, f"grad causal {sz.grad_seq}", seq=sz.grad_seq)
    grad_case(sz, f"grad GQA {h}/{h // 4} causal {sz.gqa_seq} (ref heads 0-3)",
              seq=sz.gqa_seq, group=4, ref_q=4)
    grad_case(sz, f"grad packed {n_docs}x{sz.doc} causal {sz.gqa_seq} "
              "(ref heads 0-3)", seq=sz.gqa_seq, doc=sz.doc, ref_q=4)
    decode_cases(sz)
    paged_cases(sz)


# ---------------------------------------------------------------- engine --

def engine_phase(sz: Sizes, cfg) -> None:
    from flash_attention_tpu.models.attention import _output_proj, _project_qkv
    from flash_attention_tpu.models.transformer import _trunk, init_model_params
    from flash_attention_tpu.ops.reference import reference_attention
    from flash_attention_tpu.serving.engine import Request
    from flash_attention_tpu.serving.paged_engine import PagedServingEngine

    log(f"engine: {cfg}")
    t0 = time.perf_counter()
    params = init_model_params(jax.random.key(0), cfg)
    jax.block_until_ready(params)
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    log(f"  params: {n_params / 1e9:.3f} B ({time.perf_counter() - t0:.1f} s)")

    slots, pps = sz.engine_slots, sz.engine_pages_per_slot
    engine = PagedServingEngine(
        params, cfg, max_slots=slots, num_pages=slots * pps + 1,
        pages_per_slot=pps, page_size=sz.page, prefill_chunk=sz.engine_chunk,
    )
    rng = np.random.RandomState(12)
    reqs = [
        Request(id=i, prompt=tuple(int(t) for t in rng.randint(0, cfg.vocab_size, n)),
                max_new_tokens=sz.new_tokens)
        for i, n in enumerate(sz.engine_prompts)
    ]
    t0 = time.perf_counter()
    out = engine.run(reqs)
    dt = time.perf_counter() - t0
    for r in reqs:
        toks = out[r.id].tokens
        check(len(toks) == sz.new_tokens,
              f"request {r.id}: {len(toks)} tokens != {sz.new_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {r.id}: token out of range")
    log(f"  served {len(reqs)} requests (prompts {min(sz.engine_prompts)}-"
        f"{max(sz.engine_prompts)} tokens, {sz.new_tokens} new tokens each) "
        f"in {dt:.1f} s incl. compilation; {engine.decode_tokens} decode tokens")

    # What XLA reserves for the engine's own decode-block program.
    zi = jnp.zeros((slots,), jnp.int32)
    zf = jnp.zeros((slots,), jnp.float32)
    lowered = engine._decode_multi.lower(
        params, zi, engine.caches, jnp.ones((slots,), bool), zf, zi,
        jnp.ones((slots,), jnp.float32), zi, engine.decode_block_steps, True,
    )
    log(f"  decode step memory_analysis: {lowered.compile().memory_analysis()}")

    # One request's prefill logits through the engine's own chunk program vs
    # a plain forward on the reference attention.
    prompt = jnp.asarray(reqs[2].prompt, jnp.int32)[None]
    chunk = engine.chunk
    n_chunks = prompt.shape[1] // chunk
    prompt = prompt[:, : n_chunks * chunk]
    caches = engine._set_slot_table(
        jnp.arange(1, pps + 1, dtype=jnp.int32), engine.caches, 0
    )
    for c in range(n_chunks):
        logits, caches = engine._prefill_chunk_step(
            params, prompt[:, c * chunk:(c + 1) * chunk], caches, 0,
            c * chunk, (c + 1) * chunk,
        )

    def ref_attn(p, acfg, h, cache):
        t = h.shape[1]
        q, k, v = _project_qkv(p, acfg, h, jnp.arange(t)[None, None, :])
        with jax.default_matmul_precision("highest"):
            o = reference_attention(q, k, v, causal=True)
        return _output_proj(p, o, h.dtype), cache

    want, _ = jax.jit(lambda p, t: _trunk(p, cfg, t, ref_attn))(params, prompt)
    want = want[:, -chunk:]
    compare_rel(f"prefill logits ({n_chunks} engine chunks of {chunk}) vs "
                "reference forward", logits, want, LOGIT_REL_LIMIT)
    agree = float(jnp.mean(jnp.argmax(logits, -1) == jnp.argmax(want, -1)))
    log(f"  prefill next-token argmax agreement: {agree:.4f}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")


# ---------------------------------------------------------- four devices --

def _collectives(compiled) -> dict:
    """Cross-device ops in a compiled program, by kind."""
    text = compiled.as_text()
    kinds = ("all-gather", "all-reduce", "all-to-all", "collective-permute",
             "reduce-scatter")
    return {k: text.count(f" {k}(") + text.count(f" {k}-start(") for k in kinds}


def _check_head_shards(name, out, n, heads_per_shard):
    devs = len(out.sharding.device_set)
    check(devs == n, f"{name}: spans {devs} devices, not {n}")
    shard = out.addressable_shards[0].data.shape
    check(shard[1] == heads_per_shard,
          f"{name}: {shard[1]} heads per shard, not {heads_per_shard}")
    log(f"  {name}: {devs} devices, per-shard shape {shard}")


def multi_device_phase(sz: Sizes, n: int, cfg) -> None:
    from jax.sharding import NamedSharding, PartitionSpec as P

    from flash_attention_tpu.models.transformer import (
        forward,
        init_caches,
        init_model_params,
    )
    from flash_attention_tpu.ops.decode import decode_attention
    from flash_attention_tpu.ops.flash_attention import flash_attention
    from flash_attention_tpu.ops.quant import quantize_kv
    from flash_attention_tpu.parallel.mesh import make_mesh
    from flash_attention_tpu.parallel.ring import make_ring_attention
    from flash_attention_tpu.parallel.sharding import (
        make_sharded_decode_attention,
        make_sharded_flash_attention,
    )
    from flash_attention_tpu.utils.testing import make_qkv

    devices = jax.devices()[:n]
    log(f"multi-device: {n} x {devices[0].device_kind}; model {cfg}")
    data, model = 2, n // 2
    mesh = make_mesh(data=data, model=model, devices=devices)
    hq, hkv = cfg.num_q_heads, cfg.num_kv_heads

    # Head-sharded attention through the shard_map wrappers: each device
    # runs the kernel on its own heads, with no collective in the program.
    q, k, v = make_qkv(15, data, hq, sz.seq, cfg.head_dim, num_kv_heads=hkv)
    sharded_fa = make_sharded_flash_attention(mesh, causal=True)
    label = f"shard_map attention dp={data} x tp={model} {hq}/{hkv} {sz.seq}"
    coll = _collectives(sharded_fa.lower(q, k, v).compile())
    log(f"  {label} collectives: {coll}")
    check(not any(coll.values()), f"{label}: collectives {coll}")
    o = sharded_fa(q, k, v)
    _check_head_shards(label, o, n, hq // model)
    compare(f"{label} vs one device", o,
            jax.jit(functools.partial(flash_attention, causal=True))(q, k, v))

    b = sz.decode_batch
    qd, kd, vd = make_qkv(16, b, hq, 1, cfg.head_dim, num_kv_heads=hkv,
                          kv_seq=sz.decode_seq)
    qd = qd[:, :, 0, :]
    kq, vq = quantize_kv(kd, vd, "int8")
    lengths = jax.random.randint(jax.random.key(17), (b,), 1, sz.decode_seq + 1)
    lengths = lengths.astype(jnp.int32)
    sharded_dec = make_sharded_decode_attention(mesh)
    label = f"shard_map decode int8 dp={data} x tp={model} b={b} s={sz.decode_seq}"
    coll = _collectives(sharded_dec.lower(qd, kq, vq, lengths).compile())
    log(f"  {label} collectives: {coll}")
    check(not any(coll.values()), f"{label}: collectives {coll}")
    od = sharded_dec(qd, kq, vq, lengths)
    _check_head_shards(label, od, n, hq // model)
    compare(f"{label} vs one device", od,
            jax.jit(decode_attention)(qd, kq, vq, lengths))

    # dp x tp serving step of the model (NamedSharding placement, XLA's
    # partitioner): prefill, then one decode step, on dense caches.
    params = init_model_params(jax.random.key(0), cfg)
    batch, max_seq = 2 * data, 2 * sz.mesh_prompt
    tokens = jax.random.randint(jax.random.key(1), (batch, sz.mesh_prompt), 0,
                                cfg.vocab_size)

    def step(params, tokens, caches):
        logits, caches = forward(params, cfg, tokens, caches)
        nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        dec, _ = forward(params, cfg, nxt, caches, decode=True)
        return logits[:, -1], dec[:, -1]

    one = jax.jit(step)(params, tokens, init_caches(cfg, batch, max_seq))

    def put(path, x):
        name = getattr(path[-1], "key", None)
        spec = P()
        if name in ("wq", "wk", "wv"):
            spec = P(None, "model", None)
        elif name == "wo":
            spec = P("model", None, None)
        return jax.device_put(x, NamedSharding(mesh, spec))

    args = (
        jax.tree_util.tree_map_with_path(put, params),
        jax.device_put(tokens, NamedSharding(mesh, P("data", None))),
        jax.tree_util.tree_map(
            lambda x: jax.device_put(x, NamedSharding(
                mesh, P("data") if x.ndim == 1 else P("data", "model", None, None))),
            init_caches(cfg, batch, max_seq),
        ),
    )
    compiled = jax.jit(step).lower(*args).compile()
    log(f"  dp={data} x tp={model} model step collectives: "
        f"{_collectives(compiled)}")
    sharded = compiled(*args)
    for name, got, want in zip(("prefill logits", "decode logits"), sharded, one):
        check(len(got.sharding.device_set) == n,
              f"{name} spans {len(got.sharding.device_set)} devices, not {n}")
        compare_rel(f"dp={data} x tp={model} {name} vs one device",
                    got, want, LOGIT_REL_LIMIT)

    # Ring attention, forward and gradient, vs the one-device kernel. The
    # cotangent weights are an argument: closed over, XLA would fold the
    # zigzag permutation's scatter of a constant at compile time.
    seq = n * sz.ring_seq_per_device
    q, k, v = make_qkv(13, 1, sz.ring_heads, seq, sz.head_dim)
    w = jax.random.normal(jax.random.key(14), q.shape, jnp.float32)

    def loss(fn):
        return lambda q, k, v, w: jnp.sum(fn(q, k, v).astype(jnp.float32) * w)

    def single(q, k, v):
        return flash_attention(q, k, v, causal=True)

    want_o = jax.jit(single)(q, k, v)
    want_g = jax.jit(jax.grad(loss(single), argnums=(0, 1, 2)))(q, k, v, w)
    ring_mesh = make_mesh(context=n, devices=devices)
    for zig in (False, True):
        ring = make_ring_attention(ring_mesh, causal=True, zigzag=zig)
        label = (f"ring {'zigzag' if zig else 'contiguous'} "
                 f"seq {n}x{sz.ring_seq_per_device}")
        o = ring(q, k, v)
        check(len(o.sharding.device_set) == n, f"{label}: output not on {n} devices")
        compare(f"{label} out vs one device", o, want_o)
        grads = jax.jit(jax.grad(loss(ring), argnums=(0, 1, 2)))(q, k, v, w)
        for g, wg, part in zip(grads, want_g, "qkv"):
            check(len(g.sharding.device_set) == n, f"{label} d{part} devices")
            compare_rel(f"{label} d{part} vs one device", g, wg,
                        GRAD_REL_LIMIT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4),
                        help="4: run only the multi-device paths")
    args = parser.parse_args()

    from flash_attention_tpu.utils.compile_cache import enable_compile_cache

    device_phase(args.devices)
    enable_compile_cache()
    t0 = time.perf_counter()
    sz = Sizes()
    if args.devices == 1:
        ops_phase(sz)
        log(f"ops phase done in {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        engine_phase(sz, sz.model_config(kv_quant="int8"))
        log(f"engine phase done in {time.perf_counter() - t1:.1f} s")
    else:
        multi_device_phase(sz, args.devices,
                           sz.model_config(num_layers=sz.mesh_layers))
        log(f"multi-device phase done in {time.perf_counter() - t0:.1f} s")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
