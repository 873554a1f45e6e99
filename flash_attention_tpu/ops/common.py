"""Shared numerics constants and the Pallas launch policy for the kernels.

Numerics policy (SURVEY.md §5): fp32 accumulators, exp2-domain softmax with
log2(e) folded into the scale (the reference folds it the same way,
flash_attention.cu:239), and a large finite negative mask value rather than
-inf (the reference uses -10000, flash_attention.cu:238 — ours is fp32-scaled
so exp2 of it underflows to exactly 0).

Launch policy: every Pallas kernel in this package is written for the GPU's
Triton route (``backend="triton"``). Interpret mode (the Pallas interpreter on
the host) runs only when asked for — per call (``interpret=True``) or
process-wide through :func:`set_interpret_default`, which the test suite turns
on. A kernel called on any other backend without that request raises.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

LOG2E = 1.4426950408889634
MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)
# Floor for the running row max: a fully-masked row's max is MASK_VALUE
# (~-2e38); computing exp2(s - m) there subtracts two huge values whose
# rounding residual can be large — and exp2 of a positive residual is inf ->
# NaN downstream. Starting m at this floor (far above any masked score, far
# below any real logit) makes masked rows underflow to exactly 0 instead.
M_FLOOR = -1e30

_INTERPRET_DEFAULT = False


def ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def set_interpret_default(enabled: bool) -> None:
    """Run every Pallas kernel through the interpreter unless a call says
    otherwise (tests and CPU rehearsals of the multi-device paths)."""
    global _INTERPRET_DEFAULT
    _INTERPRET_DEFAULT = bool(enabled)


def resolve_interpret(interpret: bool | None) -> bool:
    """The one place a kernel decides between the GPU and the interpreter."""
    if interpret is None:
        interpret = _INTERPRET_DEFAULT
    if not interpret:
        backend = jax.default_backend()
        if backend != "gpu":
            raise RuntimeError(
                f"Pallas kernels here compile for the GPU only, but the JAX "
                f"backend is {backend!r}; pass interpret=True or call "
                f"flash_attention_tpu.ops.common.set_interpret_default(True) "
                f"to run them in the Pallas interpreter"
            )
    return bool(interpret)


def triton_params(num_warps: int, num_stages: int):
    from jax.experimental.pallas import triton as pltriton

    return pltriton.CompilerParams(num_warps=num_warps, num_stages=num_stages)
