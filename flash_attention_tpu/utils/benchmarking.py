"""Benchmark timing harness with the reference's exact protocol.

Re-creates C10 (SURVEY.md §2; flash_attention.cu:886-971): per config, a fixed
warmup count, a timed loop, several runs averaged, and
TFLOPS = 4·B·H·S²·D / time, halved for causal (flash_attention.cu:938-939).
cudaEvent timing becomes ``jax.block_until_ready`` wall-clock timing; the
regs/occupancy introspection block (C8) becomes %-of-roofline reporting
against the device's published peaks.
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time

import jax


def attention_flops(
    batch: int, heads: int, seq: int, head_dim: int, *, causal: bool,
    kv_seq: int | None = None, window: int | None = None,
) -> float:
    """The reference's FLOPs formula: 4·B·H·Sq·Skv·D, halved for causal
    (flash_attention.cu:938-939). With a causal sliding window only the
    live band counts: row r attends to min(r+1, window) columns, so the
    band area is W(W+1)/2 + (S-W)·W for S >= W."""
    kv = seq if kv_seq is None else kv_seq
    if window is not None:
        if not causal or kv_seq is not None:
            raise ValueError("window FLOPs accounting assumes causal self-attention")
        w = min(window, seq)
        band = w * (w + 1) / 2 + (seq - w) * w
        return 4.0 * batch * heads * band * head_dim
    flops = 4.0 * batch * heads * seq * kv * head_dim
    if causal:
        flops /= 2
    return flops


# Published dense peaks per device, keyed by ``jax.Device.device_kind``:
# (bf16/fp16 tensor-core TFLOP/s, device-memory bytes/s). Source: NVIDIA's
# H100 data sheet, SXM part, without sparsity, at the 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 3.35e12),
}


def device_peaks(device=None) -> tuple[float, float]:
    """(peak TFLOP/s, peak bytes/s) of ``device`` (default: device 0).
    A device missing from the table is an error, not a default."""
    kind = (device or jax.devices()[0]).device_kind
    if kind not in DEVICE_PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {kind!r}; add it to "
            f"DEVICE_PEAKS with its source"
        )
    return DEVICE_PEAKS[kind]


def peak_tflops(device=None) -> float:
    return device_peaks(device)[0]


def peak_bytes_per_s(device=None) -> float:
    return device_peaks(device)[1]


def nvidia_smi_name_and_power_limit() -> str:
    """``name, power.limit`` of GPU 0 as nvidia-smi reports them (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def device_info() -> dict:
    """What every benchmark row names: platform, device kind, device count
    and the card's power limit."""
    d = jax.devices()[0]
    return dict(
        platform=d.platform, device_kind=d.device_kind,
        device_count=len(jax.devices()),
        nvidia_smi=nvidia_smi_name_and_power_limit(),
    )


def require_gpu() -> None:
    """Measurements run on the GPU only: no CPU fallback."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"benchmarks need an NVIDIA GPU; JAX found platform {platform!r}"
        )


@dataclasses.dataclass
class BenchResult:
    name: str
    avg_time_s: float
    run_times_s: list
    tflops: float
    roofline_frac: float

    def row(self) -> str:
        runs = " ".join(f"{t * 1e3:8.3f}ms" for t in self.run_times_s)
        return (
            f"{self.name:<28s} {runs}  avg {self.avg_time_s * 1e3:8.3f}ms  "
            f"{self.tflops:7.2f} TFLOPS  ({self.roofline_frac * 100:5.1f}% roofline)"
        )


def time_fn(
    fn,
    *args,
    warmup: int = 20,
    iters: int = 100,
    runs: int = 3,
    inter_run_sleep_s: float = 0.0,
) -> list:
    """The reference's timing protocol: `warmup` untimed dispatches, then
    `iters` timed dispatches, repeated `runs` times (flash_attention.cu:941-956).
    cudaEvent timing becomes wall-clock around the dispatch loop, ended by
    ``jax.block_until_ready``. Returns per-run average seconds per iteration."""
    out = fn(*args)
    for _ in range(max(0, warmup - 1)):
        out = fn(*args)
    jax.block_until_ready(out)

    run_times = []
    for _ in range(runs):
        start = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        elapsed = time.perf_counter() - start
        run_times.append(max(elapsed, 1e-9) / iters)
        if inter_run_sleep_s:
            time.sleep(inter_run_sleep_s)
    return run_times


def _round_pow2(x: float, lo: int, hi: int) -> int:
    import math as _math

    k = max(0, round(_math.log2(max(x, 1.0))))
    return max(lo, min(hi, 2**k))


def scan_timer(
    fn,
    args,
    *,
    target_lo_s: float = 0.04,
    target_hi_s: float = 0.16,
    iters: int = 3,
    runs: int = 3,
    est_s: float | None = None,
    chain: str = "barrier",
) -> float:
    """Robust seconds-per-op via in-graph lax.scan repeats + slope fit.

    The op runs ``reps`` times inside one jitted scan, dependency-chained so
    XLA cannot hoist or dedupe iterations, at two repeat counts; the slope
    between them cancels every fixed per-invocation cost (dispatch, launch,
    sync) — the equivalent of the reference's cudaEvent-around-100-dispatches
    loop (flash_attention.cu:949-956).

    chain: "barrier" threads every arg through optimization_barrier each
      iteration; "add" perturbs only the first arg with tok*0 (cannot be
      algebraically folded: NaN*0 = NaN). Use "add" when the op captures
      large arrays.

    Partial-output trap: the chain consumes only the FIRST element of the
    first output leaf. If ``fn`` is a COMPOSITE whose other outputs don't
    feed that element, XLA dead-code-eliminates the rest and the timing is
    fiction. Tie every output that must run into that element.
    """
    import jax.numpy as jnp

    def make(reps):
        if chain == "barrier":

            @jax.jit
            def run(*a):
                def body(carry, _):
                    ca, tok = carry
                    o = fn(*ca)
                    leaf = jax.tree_util.tree_leaves(o)[0]
                    tok2 = leaf.reshape(-1)[0].astype(jnp.float32)
                    ca2 = jax.lax.optimization_barrier(a + (tok2,))
                    return (ca2[:-1], ca2[-1]), ()

                init = jax.lax.optimization_barrier(a + (jnp.float32(0),))
                (_, tok), _ = jax.lax.scan(
                    body, (init[:-1], init[-1]), None, length=reps
                )
                return tok

        else:

            @jax.jit
            def run(*a):
                def body(tok, _):
                    a0 = a[0] + tok.astype(a[0].dtype) * 0
                    o = fn(a0, *a[1:])
                    leaf = jax.tree_util.tree_leaves(o)[0]
                    return leaf.reshape(-1)[0].astype(jnp.float32), ()

                tok, _ = jax.lax.scan(body, jnp.float32(0), None, length=reps)
                return tok

        return run

    if est_s is not None:
        # Deterministic reps from a caller-supplied time model: skips the
        # calibration compile AND makes scan lengths reproducible across runs
        # (persistent-compilation-cache hits on re-benchmarks).
        est = max(est_s, 1e-7)
    else:
        t8 = min(time_fn(make(8), *args, warmup=2, iters=3, runs=2))
        est = max(t8 / 8, 1e-7)
    reps_hi = _round_pow2(target_hi_s / est, 16, 8192)
    reps_lo = reps_hi // 4
    run_lo, run_hi = make(reps_lo), make(reps_hi)
    # A slope far below the caller's physical time model cannot be real
    # (host contention can make the short scan time slower than the long
    # one): retry, then fail loudly rather than report fiction.
    floor = est / 20.0
    for attempt in range(3):
        t_lo = min(time_fn(run_lo, *args, warmup=1, iters=iters, runs=runs))
        t_hi = min(time_fn(run_hi, *args, warmup=1, iters=iters, runs=runs))
        per_op = (t_hi - t_lo) / (reps_hi - reps_lo)
        if per_op > floor:
            return per_op
    raise RuntimeError(
        f"scan_timer slope non-physical after 3 attempts: {per_op:.3e}s/op "
        f"vs model {est:.3e}s (host contention?)"
    )


def bench_attention(
    fn,
    *args,
    name: str,
    flops: float,
    warmup: int = 20,
    iters: int = 100,
    runs: int = 3,
    peak: float | None = None,
) -> BenchResult:
    run_times = time_fn(fn, *args, warmup=warmup, iters=iters, runs=runs)
    avg = statistics.mean(run_times)
    tflops = flops / avg / 1e12
    peak = peak if peak is not None else peak_tflops()
    return BenchResult(
        name=name,
        avg_time_s=avg,
        run_times_s=run_times,
        tflops=tflops,
        roofline_frac=tflops / peak,
    )
