"""Tracing / profiling helpers — the SURVEY §5 tracing subsystem.

The reference's observability is cudaEvent timing plus a regs/occupancy
introspection block (flash_attention.cu:712-755, 949-956). The JAX
equivalents here:

  * :func:`trace` — capture a ``jax.profiler`` device trace around a code
    block (open the output dir with TensorBoard or xprof to see per-kernel
    device timelines).
  * :func:`profile_op` — one-call summary: runs a jitted fn under the
    profiler with proper warmup and reports wall time alongside the
    compiled-executable cost/memory analysis.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Capture a jax.profiler trace for the enclosed block.

    Args:
      host_tracer_level: host-side tracing detail (0 = off, 1 = critical
        only, 2 = default, 3 = verbose), forwarded via ProfileOptions.

    Usage::

        with trace("/tmp/fa_trace"):
            out = flash_attention(q, k, v, causal=True)
            jax.block_until_ready(out)
    """
    opts = jax.profiler.ProfileOptions()
    opts.host_tracer_level = host_tracer_level
    jax.profiler.start_trace(
        log_dir, create_perfetto_trace=False, profiler_options=opts
    )
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profile_op(fn, *args, warmup: int = 3, iters: int = 10, log_dir: str | None = None):
    """Run ``fn(*args)`` under the profiler; return a summary dict.

    The summary carries wall-clock seconds per call (after warmup), plus the
    XLA cost analysis (flops / bytes accessed / transcendentals) and memory
    analysis of the compiled executable when ``fn`` is jitted.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)

    ctx = trace(log_dir) if log_dir else contextlib.nullcontext()
    with ctx:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        wall = (time.perf_counter() - t0) / iters

    summary = {"wall_s_per_call": wall, "trace_dir": log_dir}
    try:
        compiled = fn.lower(*args).compile()  # works for jitted fns
        summary["cost_analysis"] = compiled.cost_analysis()
        mem = compiled.memory_analysis()
        summary["memory_analysis"] = {
            "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
            "output_bytes": getattr(mem, "output_size_in_bytes", None),
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "peak_bytes": getattr(mem, "peak_memory_in_bytes", None),
        }
    except Exception:  # non-jitted fn, backend without cost analysis, ...
        pass
    return summary
