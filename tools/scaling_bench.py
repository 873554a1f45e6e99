"""Multi-chip scaling-efficiency harness.

BASELINE.md commits to ">=85% scaling efficiency to 2+ hosts"; this script
makes that measurable the day a pod is attached. For each mesh size
n in {1, 2, 4, ...} up to the available device count it measures, with the
PER-CHIP problem held constant (weak scaling):

  * prefill:  causal GQA flash attention, batch sharded over "data" and
    heads over "model" (the serving tp x dp layout) -> TFLOPS per chip
  * decode:   one decode step over an int8 KV cache sharded batch x heads
    -> tokens/s per chip
  * ring:     causal zigzag ring attention with the sequence sharded over
    "context" (sequence parallelism, ppermute + merge) -> TFLOPS per chip

and reports efficiency(n) = per_chip(n) / per_chip(1). Pure dp/tp shards are
communication-free by construction (the all-reduce belongs to the caller's
output projection); the ring row is the one that exercises the device links.

With --wiring it runs each configuration once without timing — the wiring
check used by __graft_entry__.dryrun_multichip. A rehearsal on virtual CPU
devices adds --interpret (the kernels then run in the Pallas interpreter).

Usage:
    python tools/scaling_bench.py [--wiring [--interpret]] [--seq=4096]
        [--decode-seq=8192]
"""

import json
import math
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from flash_attention_tpu.ops.quant import quantize_kv
from flash_attention_tpu.parallel.mesh import make_mesh
from flash_attention_tpu.parallel.ring import make_ring_attention
from flash_attention_tpu.parallel.sharding import (
    make_sharded_decode_attention,
    make_sharded_flash_attention,
)
from flash_attention_tpu.utils.benchmarking import (
    attention_flops,
    peak_tflops,
    scan_timer,
)
from flash_attention_tpu.utils.testing import make_qkv

Q_HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128


def mesh_sizes(n: int):
    sizes, s = [], 1
    while s <= n:
        sizes.append(s)
        s *= 2
    return sizes


def bench_prefill(n, *, seq, wiring, peak):
    model = math.gcd(n, KV_HEADS)
    data = n // model
    mesh = make_mesh(data=data, model=model, devices=jax.devices()[:n])
    batch = data
    q, k, v = make_qkv(0, batch, Q_HEADS, seq, HEAD_DIM, num_kv_heads=KV_HEADS)
    fn = make_sharded_flash_attention(mesh, causal=True)
    fl = attention_flops(batch, Q_HEADS, seq, HEAD_DIM, causal=True)
    if wiring:
        jax.block_until_ready(fn(q, k, v))
        return {"ok": True, "mesh": f"dp={data} tp={model}"}
    t = scan_timer(fn, (q, k, v), est_s=fl / (0.3 * peak * 1e12 * n))
    return {
        "mesh": f"dp={data} tp={model}",
        "time_us": t * 1e6,
        "tflops_per_chip": fl / t / 1e12 / n,
    }


def bench_decode(n, *, seq, batch_per_chip, wiring):
    model = math.gcd(n, KV_HEADS)
    data = n // model
    mesh = make_mesh(data=data, model=model, devices=jax.devices()[:n])
    batch = batch_per_chip * data
    _, k, v = make_qkv(1, batch, KV_HEADS, seq, HEAD_DIM)
    kq, vq = quantize_kv(k, v, "int8")
    q = make_qkv(2, batch, Q_HEADS, 1, HEAD_DIM)[0][:, :, 0, :]
    lengths = jnp.full((batch,), seq, jnp.int32)
    fn = make_sharded_decode_attention(mesh)
    if wiring:
        jax.block_until_ready(fn(q, kq, vq, lengths))
        return {"ok": True, "mesh": f"dp={data} tp={model}"}
    kv_bytes = 2 * batch * KV_HEADS * seq * HEAD_DIM  # int8 payload
    # chain="add": the int8 cache must stay a loop-invariant ARGUMENT —
    # barrier-chaining a multi-hundred-MB cache through the scan carry
    # hangs XLA's loop optimizer (see bench.py's bench_decode).
    t = scan_timer(
        fn, (q, kq, vq, lengths), est_s=kv_bytes / 700e9 / n, chain="add"
    )
    return {
        "mesh": f"dp={data} tp={model}",
        "time_us": t * 1e6,
        "tokens_per_s_per_chip": batch / t / n,
    }


def bench_ring(n, *, seq_per_chip, wiring, peak):
    mesh = make_mesh(data=1, model=1, context=n, devices=jax.devices()[:n])
    seq = seq_per_chip * n
    heads = 8
    q, k, v = make_qkv(3, 1, heads, seq, HEAD_DIM)
    fn = make_ring_attention(mesh, causal=True, zigzag=n > 1)
    fl = attention_flops(1, heads, seq, HEAD_DIM, causal=True)
    if wiring:
        jax.block_until_ready(fn(q, k, v))
        return {"ok": True, "mesh": f"ctx={n}"}
    t = scan_timer(fn, (q, k, v), est_s=fl / (0.3 * peak * 1e12 * n))
    return {
        "mesh": f"ctx={n}",
        "time_us": t * 1e6,
        "tflops_per_chip": fl / t / 1e12 / n,
    }


def run(wiring: bool, seq: int, decode_seq: int, ring_seq_per_chip: int):
    peak = None if wiring else peak_tflops()
    n_dev = len(jax.devices())
    results = {}
    for mode, bench in [
        ("prefill", lambda n: bench_prefill(n, seq=seq, wiring=wiring, peak=peak)),
        ("decode", lambda n: bench_decode(
            n, seq=decode_seq, batch_per_chip=8, wiring=wiring)),
        ("ring", lambda n: bench_ring(
            n, seq_per_chip=ring_seq_per_chip, wiring=wiring, peak=peak)),
    ]:
        rows = []
        for n in mesh_sizes(n_dev):
            r = bench(n)
            r["n"] = n
            rows.append(r)
            print(f"{mode:8s} n={n}: {json.dumps(r)}", flush=True)
        key = next(
            (k for k in ("tflops_per_chip", "tokens_per_s_per_chip")
             if rows and k in rows[0]),
            None,
        )
        if key:
            base = rows[0][key]
            for r in rows:
                r["efficiency"] = r[key] / base
                print(
                    f"{mode:8s} n={r['n']}: {r[key]:.1f} per-chip, "
                    f"{r['efficiency'] * 100:.1f}% of linear",
                    flush=True,
                )
        results[mode] = rows
    print(json.dumps({"scaling": results}))
    return results


def main():
    wiring = "--wiring" in sys.argv
    if "--interpret" in sys.argv:
        if not wiring:
            sys.exit("--interpret runs no timing: give it with --wiring")
        from flash_attention_tpu.ops.common import set_interpret_default

        set_interpret_default(True)
    # Wiring mode defaults to tiny shapes (it only validates mesh wiring +
    # sharding), but an EXPLICIT --seq/--decode-seq/--ring-seq-per-chip
    # always wins so specific dispatch tiers can be wiring-checked too.
    seq = decode_seq = ring_seq_per_chip = None
    for a in sys.argv[1:]:
        if a.startswith("--seq="):
            seq = int(a.split("=")[1])
        if a.startswith("--decode-seq="):
            decode_seq = int(a.split("=")[1])
        if a.startswith("--ring-seq-per-chip="):
            ring_seq_per_chip = int(a.split("=")[1])
    defaults = (256, 256, 128) if wiring else (4096, 8192, 1024)
    seq = defaults[0] if seq is None else seq
    decode_seq = defaults[1] if decode_seq is None else decode_seq
    ring_seq_per_chip = defaults[2] if ring_seq_per_chip is None else ring_seq_per_chip
    run(wiring, seq, decode_seq, ring_seq_per_chip)


if __name__ == "__main__":
    main()
