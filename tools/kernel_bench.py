"""Time each hand-written kernel against what XLA makes of the plain version
(and cuDNN's fused attention where it applies), at the chip smoke's shapes.

    python tools/kernel_bench.py [--sections decode,write,forward,train,sweep]
        [--out build/kernel_bench.json]

GPU only. Times (ms) are host wall-clock per call around ``block_until_ready``
(minimum over runs of the mean over iterations), after warmup; a variant that
fails (e.g. the plain version running out of memory on seq x seq scores) is
recorded with its error, and plain versions whose seq x seq fp32 scores
would not fit are skipped. ``--sections`` picks which parts run (default:
decode, write, forward and train; ``sweep`` times the forward's pipeline
depth), so each can get its own time limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from flash_attention_tpu.ops.flash_attention import flash_attention  # noqa: E402
from flash_attention_tpu.ops.tuning import BlockSizes  # noqa: E402
from flash_attention_tpu.utils.benchmarking import (  # noqa: E402
    attention_flops,
    device_info,
    require_gpu,
    time_fn,
)
from flash_attention_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from flash_attention_tpu.utils.testing import make_qkv  # noqa: E402

ROWS = []
# Plain versions whose seq x seq fp32 scores exceed this are not run.
SCORES_LIMIT_GB = 16


def timed(fn, *args, iters=10):
    try:
        jax.block_until_ready(fn(*args))
        return min(time_fn(fn, *args, warmup=2, iters=iters, runs=3)) * 1e3
    except Exception as e:  # noqa: BLE001 — recorded, e.g. out of memory
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def record(kind, case, **times):
    row = dict(kind=kind, case=case, **times)
    ROWS.append(row)
    cells = "  ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in times.items()
    )
    print(f"{kind:8s} {case:42s} {cells}", flush=True)


def plain_attention(q, k, v, *, causal, window=None, softcap=None, seg=None):
    """The straightforward version: bf16 operands, fp32 scores and softmax."""
    group = q.shape[1] // k.shape[1]
    k = jnp.repeat(k, group, axis=1)
    v = jnp.repeat(v, group, axis=1)
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k, preferred_element_type=jnp.float32)
    s = s / math.sqrt(q.shape[-1])
    if softcap is not None:
        s = softcap * jnp.tanh(s / softcap)
    sq, sk = q.shape[2], k.shape[2]
    row = jnp.arange(sq)[:, None] + (sk - sq)
    col = jnp.arange(sk)[None, :]
    mask = jnp.ones((sq, sk), bool)[None, None]
    if causal:
        mask = mask & (col <= row)
    if window is not None:
        mask = mask & (col > row - window)
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    s = jnp.where(mask, s, -1e30)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", p.astype(v.dtype), v)


def dpa(impl, *, causal, window=None):
    def f(q, k, v):
        out = jax.nn.dot_product_attention(
            q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
            v.transpose(0, 2, 1, 3), is_causal=causal, implementation=impl,
            local_window_size=None if window is None else (window - 1, 0),
        )
        return out.transpose(0, 2, 1, 3)

    return f


def forward_rows():
    cases = [
        ("causal 4096", 4096, 32, 128, dict(causal=True)),
        ("non-causal 4096", 4096, 32, 128, dict(causal=False)),
        ("causal 16384", 16384, 32, 128, dict(causal=True)),
        ("GQA 32/8 causal 8192", 8192, 8, 128, dict(causal=True)),
        ("window 4096 causal 16384", 16384, 32, 128,
         dict(causal=True, window=4096)),
        ("softcap 50 causal 4096", 4096, 32, 128, dict(causal=True, softcap=50.0)),
        ("packed 4x2048 causal 8192", 8192, 32, 128, dict(causal=True, doc=2048)),
        ("d64 causal 4096", 4096, 32, 64, dict(causal=True)),
    ]
    for name, seq, hkv, d, kw in cases:
        q, k, v = make_qkv(0, 1, 32, seq, d, num_kv_heads=hkv)
        doc = kw.pop("doc", None)
        seg = None
        if doc:
            seg = jnp.repeat(jnp.arange(seq // doc, dtype=jnp.int32), doc)[None]
        kern = jax.jit(lambda q, k, v, kw=kw, seg=seg: flash_attention(
            q, k, v, causal=kw["causal"], sliding_window=kw.get("window"),
            logit_softcap=kw.get("softcap"), segment_ids=seg))
        plain = jax.jit(functools.partial(plain_attention, seg=seg, **kw))
        times = dict(kernel=timed(kern, q, k, v))
        scores_gb = 32 * seq * seq * 4 / 1e9
        if scores_gb > SCORES_LIMIT_GB:
            # The allocator retries a failing 32 GB request for minutes.
            times["plain_xla"] = f"skipped: fp32 scores need {scores_gb:.0f} GB"
        else:
            times["plain_xla"] = timed(plain, q, k, v)
        if "softcap" not in kw and seg is None and scores_gb <= SCORES_LIMIT_GB:
            times["xla_dpa"] = timed(jax.jit(dpa("xla", **kw)), q, k, v)
        if "softcap" not in kw and seg is None:
            times["cudnn"] = timed(jax.jit(dpa("cudnn", **kw)), q, k, v)
        fl = attention_flops(1, 32, seq, d, causal=kw["causal"],
                             window=kw.get("window"))
        if doc:
            fl = (seq // doc) * attention_flops(1, 32, doc, d, causal=True)
        if isinstance(times["kernel"], float):
            times["kernel_tflops"] = fl / (times["kernel"] * 1e-3) / 1e12
        record("forward", name, **times)


def train_rows():
    for name, seq, hkv in (("causal 2048", 2048, 32),
                           ("GQA 32/8 causal 8192", 8192, 8)):
        q, k, v = make_qkv(1, 1, 32, seq, 128, num_kv_heads=hkv)

        def grad_of(f):
            return jax.jit(jax.grad(
                lambda q, k, v: jnp.sum(f(q, k, v).astype(jnp.float32)),
                argnums=(0, 1, 2)))

        kern = grad_of(lambda q, k, v: flash_attention(q, k, v, causal=True))
        plain = grad_of(functools.partial(plain_attention, causal=True))
        record("train", f"fwd+bwd {name}",
               kernel=timed(kern, q, k, v), plain_xla=timed(plain, q, k, v),
               xla_dpa=timed(grad_of(dpa("xla", causal=True)), q, k, v),
               cudnn=timed(grad_of(dpa("cudnn", causal=True)), q, k, v))


def decode_rows():
    from flash_attention_tpu.ops.decode import decode_attention
    from flash_attention_tpu.ops.paged import (
        init_paged_cache,
        paged_decode_attention,
        paged_gather_kv,
        paged_prefill_attention,
        paged_write_prefill,
    )
    from flash_attention_tpu.ops.quant import QuantizedTensor, quantize_kv

    b, seq, page, hkv = 32, 8192, 1024, 8
    q, k, v = make_qkv(2, b, 32, 1, 128, num_kv_heads=hkv, kv_seq=seq)
    q = q[:, :, 0, :]
    lengths = jnp.full((b,), seq, jnp.int32)
    kq, vq = quantize_kv(k, v, "int8")
    dense = timed(jax.jit(decode_attention), q, kq, vq, lengths, iters=50)

    pps = seq // page
    cache = init_paged_cache(num_pages=b * pps + 1, num_slots=b,
                             pages_per_slot=pps, kv_heads=hkv, page_size=page,
                             kv_quant="int8")
    cache = cache._replace(
        page_table=(1 + jnp.arange(b * pps, dtype=jnp.int32)).reshape(b, pps))
    write = jax.jit(paged_write_prefill, donate_argnums=(0,))
    for s in range(b):
        cache = write(cache, k[s], v[s], s, seq)
    cache = cache._replace(lengths=lengths)
    paged = timed(jax.jit(paged_decode_attention), q, cache, iters=50)

    def paged_plain(q, cache):
        # Gather every slot's pages into a dense quantized copy, then decode.
        def dense_of(pages, scales):
            x = jnp.take(pages, cache.page_table, axis=0)  # [b, pps, H, page, D]
            x = x.transpose(0, 2, 1, 3, 4).reshape(b, hkv, seq, 128)
            sc = jnp.take(scales, cache.page_table, axis=0)
            sc = sc.transpose(0, 2, 1, 4, 3).reshape(b, hkv, seq, 1)
            return QuantizedTensor(x, sc)

        return decode_attention(q, dense_of(cache.k_pages, cache.k_scales),
                                dense_of(cache.v_pages, cache.v_scales),
                                cache.lengths)

    plain = timed(jax.jit(paged_plain), q, cache, iters=50)
    kv_bytes = 2 * b * hkv * seq * 128  # int8 payload read once per step
    record("decode", f"b={b} s={seq} 32/8 int8 (page {page} for paged)",
           dense_plain_jnp=dense, paged_kernel=paged, paged_plain_gather=plain,
           kv_gbytes=kv_bytes / 1e9)

    chunk = 1024
    qc = make_qkv(3, 1, 32, chunk, 128)[0]
    total = timed(jax.jit(lambda qc, c: paged_prefill_attention(
        qc, c, 0, seq, chunk_len=chunk)), qc, cache)
    gather = timed(jax.jit(lambda c: paged_gather_kv(c, 0, seq)), cache)
    kd, vd = jax.jit(lambda c: paged_gather_kv(c, 0, seq))(cache)
    attend = timed(jax.jit(lambda qc, kd, vd: flash_attention(
        qc, kd, vd, causal=True)), qc, kd, vd)
    record("prefill", f"paged chunk {chunk} at kv_end {seq} int8",
           total=total, gather=gather, forward_kernel=attend)



def write_rows():
    """One single-token write per slot into each of 32 layers' int8 page
    pools, donated as the engine donates them (XLA updates in place)."""
    from flash_attention_tpu.ops.paged import (
        init_paged_cache,
        paged_write_tokens_multi,
    )

    b, seq, page, hkv, layers = 32, 8192, 1024, 8, 32
    pps = seq // page

    def layer_cache():
        c = init_paged_cache(num_pages=b * pps + 1, num_slots=b,
                             pages_per_slot=pps, kv_heads=hkv, page_size=page,
                             kv_quant="int8")
        return c._replace(
            page_table=(1 + jnp.arange(b * pps, dtype=jnp.int32)).reshape(b, pps),
            lengths=jnp.full((b,), seq // 2, jnp.int32))

    caches = [layer_cache() for _ in range(layers)]
    k1 = make_qkv(4, b, hkv, 1, 128)[1][:, :, 0, :]
    write = jax.jit(lambda cs: paged_write_tokens_multi(
        cs, [k1] * layers, [k1] * layers, jnp.arange(b)), donate_argnums=0)
    for _ in range(3):
        caches = write(caches)
    jax.block_until_ready(caches)
    iters, t = 50, time.perf_counter()
    for _ in range(iters):
        caches = write(caches)
    jax.block_until_ready(caches)
    record("write", f"{layers} layers x {b} slots, one token each (XLA "
           "scatter, donated)",
           xla_scatter=(time.perf_counter() - t) / iters * 1e3)


def sweep_rows():
    """Pipeline depth of the forward (2 vs 3 stages) on plain and packed
    shapes, and of the packed fwd+bwd."""
    for name, seq, hkv, doc, causal in (
        ("causal 4096", 4096, 32, None, True),
        ("non-causal 4096", 4096, 32, None, False),
        ("GQA 32/8 causal 8192", 8192, 8, None, True),
        ("packed 4x2048 causal 8192", 8192, 32, 2048, True),
    ):
        q, k, v = make_qkv(0, 1, 32, seq, 128, num_kv_heads=hkv)
        seg = None
        if doc:
            seg = jnp.repeat(jnp.arange(seq // doc, dtype=jnp.int32), doc)[None]
        times = {}
        for stages in (2, 3):
            bs = BlockSizes(128, 64, 4, stages)
            f = jax.jit(lambda q, k, v, bs=bs: flash_attention(
                q, k, v, causal=causal, segment_ids=seg, block_sizes=bs))
            times[f"fwd_s{stages}"] = timed(f, q, k, v)
        if doc:
            for fwd_stages, bwd_stages in ((3, 2), (2, 2)):
                fb = BlockSizes(128, 64, 4, fwd_stages)
                bb = BlockSizes(64, 64, 4, bwd_stages)
                g = jax.jit(jax.grad(
                    lambda q, k, v, fb=fb, bb=bb: jnp.sum(flash_attention(
                        q, k, v, causal=True, segment_ids=seg, block_sizes=fb,
                        bwd_block_sizes=bb).astype(jnp.float32)),
                    argnums=(0, 1, 2)))
                times[f"fwdbwd_s{fwd_stages}_{bwd_stages}"] = timed(g, q, k, v)
        record("sweep", name, **times)


SECTIONS = dict(decode=decode_rows, write=write_rows, forward=forward_rows,
                train=train_rows, sweep=sweep_rows)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--sections", default="decode,write,forward,train",
                        help=f"comma-separated, from {','.join(SECTIONS)}")
    parser.add_argument("--out", default="build/kernel_bench.json")
    args = parser.parse_args()
    names = args.sections.split(",")
    unknown = set(names) - set(SECTIONS)
    if unknown:
        parser.error(f"unknown sections {sorted(unknown)}")
    require_gpu()
    enable_compile_cache()
    info = device_info()
    print(f"device: {info}", flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for name in names:
        SECTIONS[name]()
        # Written after every section, so a cut run keeps what it measured.
        out.write_text(json.dumps(dict(device=info, rows=ROWS), indent=1))


if __name__ == "__main__":
    main()
