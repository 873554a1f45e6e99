"""Shared multi-step decode machinery for both serving engines.

The dense (serving/engine.py) and paged (serving/paged_engine.py) engines run
the SAME blocked-decode host loop — one jitted k-step lax.scan dispatch + one
device->host readback per block of up to `decode_block_steps` tokens — and
differ only in (a) which per-token logits function advances the model
(decode_step_logits vs decode_step_logits_paged) and (b) what happens when a
slot finishes mid-block (the paged engine must release its pages). Both live
here once, parameterized on those two hooks.

Reference analog: the hot serving loop the reference times end-to-end
(flash_attention.cu:941-960) — dispatch overhead amortized over a block, not
paid per token.
"""

from __future__ import annotations

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from flash_attention_tpu.serving.sampling import sample_tokens


def start_prefill(eng, req, slot: int) -> None:
    """Admit one request into a prefill state (shared by both engines).

    The prompt is right-padded to the engine's chunk grid, CLAMPED to the
    slot capacity: the grid need not divide max_seq (dense) and may
    overshoot the page table (paged) — the final chunk is simply shorter.
    Without the clamp a 900-token prompt at max_seq=1000, chunk=256 padded
    to 1024 rows: a trace-time dynamic-slice error on the dense cache, and
    on the paged engine an out-of-bounds page index whose clamped gather
    can overwrite a REAL page with padding garbage.
    """
    from flash_attention_tpu.serving.engine import _PrefillState

    n_chunks = max(1, -(-len(req.prompt) // eng.chunk))
    padded_len = min(n_chunks * eng.chunk, eng.max_seq)
    padded = np.zeros((padded_len,), np.int32)
    padded[: len(req.prompt)] = req.prompt
    eng._prefills[slot] = _PrefillState(req=req, padded=padded)
    eng._dev_dirty = True
    sp = req.sampling
    eng._temps[slot] = sp.temperature
    eng._topk[slot] = sp.top_k
    eng._topp[slot] = sp.top_p
    eng._seeds[slot] = sp.seed


def advance_prefill(eng, slot: int, out) -> None:
    """Run ONE chunk of the pending prefill on `slot` (shared host loop).

    Engine-specific pieces ride the shared attribute surface:
    `_prefill_chunk_step` (dense vs paged chunk jit), `_set_slot_length_fn`
    (cache-donating length fix), and `_on_slot_finished` (page release for
    the paged engine) — same hook pattern as run_decode_block.
    """
    from flash_attention_tpu.serving.engine import Completion

    st = eng._prefills[slot]
    c = st.next_chunk
    lo = c * eng.chunk
    hi = min((c + 1) * eng.chunk, len(st.padded))
    toks = jnp.asarray(st.padded[None, lo:hi])
    logits, eng.caches = eng._prefill_chunk_step(
        eng.params, toks, eng.caches, jnp.int32(slot), jnp.int32(lo), hi
    )
    st.next_chunk += 1
    eng.events.append(("chunk", slot))
    if st.next_chunk * eng.chunk < len(st.padded):
        return
    # Last chunk done: fix the true length, sample the first token.
    req = st.req
    true_len = len(req.prompt)
    eng.caches = eng._set_slot_length_fn(
        eng.caches, jnp.int32(slot), jnp.int32(true_len)
    )
    local_idx = (true_len - 1) - (st.next_chunk - 1) * eng.chunk
    first = int(
        eng._sample_first(
            logits[:, local_idx],
            jnp.float32(eng._temps[slot]),
            jnp.int32(eng._topk[slot]),
            jnp.float32(eng._topp[slot]),
            jnp.int32(eng._seeds[slot]),
            jnp.int32(true_len),
        )
    )
    del eng._prefills[slot]
    eng.sched.prefill_done(slot)
    eng._dev_dirty = True
    eng._cur_len[slot] = true_len
    eng._remaining[slot] = req.max_new_tokens - 1
    out.setdefault(req.id, Completion(req.id, [], False))
    out[req.id].tokens.append(first)
    eng.last_token[slot] = first
    is_eos = eng.eos_id is not None and first == eng.eos_id
    if is_eos:
        out[req.id].finished_by_eos = True
    if eng.sched.record_token(slot, is_eos):
        eng._on_slot_finished(slot)


def warmup_engine(eng, *, prompt_len: int | None = None) -> None:
    """Pre-compile EVERY program a serving run can hit, then zero counters.

    One throwaway request walks both compile surfaces:

      * prefill: a full-length prompt visits every chunk position, so all
        static-kv_end prefill-chunk programs compile here (kv_end is a
        static jit arg — each chunk horizon is its own XLA program);
      * decode: ``max_new = 2 * decode_block_steps`` makes the remaining
        budget walk every power-of-two block length. The budget after the
        prefill-sampled first token is ``max_new - 1 = 2B - 1``, so blocks
        run at k = B, B/2, ..., 2, 1 — an off-by-one here (e.g. warming
        with max_new = 2B - 1) silently skips k=1 and its ~20 s compile
        lands in the first PRODUCTION run's decode phase (observed as the
        round-3 bench's 131 tok/s engine row: one 21.8 s k=1 compile inside
        a 15 s decode window).

    Safe to call more than once; later calls hit the jit caches. Counters
    (steps, decode_tokens, decode_time_s, events) are reset so a following
    measured run reports steady state only.
    """
    from flash_attention_tpu.serving.engine import Request

    blk = eng.decode_block_steps
    max_new = 2 * blk
    cap = eng.max_seq - max_new
    if cap < 1:
        raise ValueError(
            f"max_seq={eng.max_seq} leaves no room for a warmup prompt "
            f"(needs >= {max_new + 1})"
        )
    plen = cap if prompt_len is None else min(prompt_len, cap)
    plen = max(1, plen)
    # Prefix registration during warmup would squat pool pages / pollute the
    # prefix table with a synthetic prompt; suspend it for the throwaway run.
    had_prefix = getattr(eng, "prefix_cache_enabled", False)
    if had_prefix:
        eng.prefix_cache_enabled = False
    try:
        # Large positive id: the C++ scheduler reserves negatives as its
        # empty-slot sentinel (slot_request returns None for id < 0).
        eng.run([Request(id=(1 << 62) + 41, prompt=(7,) * plen,
                         max_new_tokens=max_new)])
    finally:
        if had_prefix:
            eng.prefix_cache_enabled = True
    eng.steps = 0
    eng.decode_tokens = 0
    eng.decode_time_s = 0.0
    eng.events.clear()


def make_decode_multi(model_cfg, decode_logits_fn):
    """Build the jitted k-step decode block for one engine.

    Returns a function (params, last_tok, caches, active, temps, topk, topp,
    seeds, k) -> ([k, slots] token block, final last-token row, caches): k
    decode steps in ONE dispatch via lax.scan. Inactive slots keep frozen
    lengths and tokens each step (their lanes are free riders in the batched
    kernels — what makes continuous batching continuous).

    (Params stay a per-call argument: closing over them would bake every
    weight into the executable as a constant. Passing buffer handles per
    dispatch is cheap.)
    """

    @functools.partial(
        jax.jit, static_argnums=(8, 9), donate_argnums=(2,)
    )
    def _decode_multi(
        params, last_tok, caches, active, temps, topk, topp, seeds, k,
        greedy=False,
    ):
        def body(carry, _):
            tok, caches = carry
            old_lengths = [c.lengths for c in caches]
            logits, new_caches = decode_logits_fn(
                params, model_cfg, tok[:, None], caches
            )
            if greedy:
                # Every slot in the block is temperature==0 (host-checked at
                # sampling-state upload): sample_tokens would compute two
                # full [slots, vocab] sorts and a Gumbel draw only to select
                # the argmax anyway (~0.7 ms/step of pure waste at 32x32000).
                nt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            else:
                # Fold the position the sampled token will OCCUPY (old
                # length + 1): the prompt's first sampled token already
                # folded position == true_len in _sample_first, so folding
                # the raw old length here would reuse that exact Gumbel
                # vector for the second token of every completion.
                nt = sample_tokens(
                    logits, temps, topk, topp, seeds, old_lengths[0] + 1
                )
            nt = jnp.where(active, nt, tok)
            fixed = [
                c._replace(lengths=jnp.where(active, c.lengths, old))
                for c, old in zip(new_caches, old_lengths)
            ]
            return (nt, fixed), nt

        (last, caches), toks = jax.lax.scan(
            body, (last_tok, caches), None, length=k
        )
        return toks, last, caches

    return _decode_multi


def retire_decode_block(eng, out) -> None:
    """Read back the in-flight decode block (if any) and do its host-side
    bookkeeping: append tokens, detect EOS / budget completion, finish slots.

    Tokens of a slot whose request ended BEFORE this block was dispatched
    (the pipelined overrun block) are dropped here: the dispatch-time
    slot -> request snapshot no longer matches the scheduler's. Tokens past
    a completion found WITHIN this block are dropped by the `finished` set,
    as before.
    """
    pend = getattr(eng, "_pending_block", None)
    if pend is None:
        return
    t0 = time.perf_counter()
    eng._pending_block = None
    toks_dev, block_active, slot_req = pend
    toks_np = np.asarray(toks_dev)  # [k_run, max_slots]
    k_run = toks_np.shape[0]
    finished: set[int] = set()
    appended = 0
    for j in range(k_run):
        for slot in block_active:
            if slot in finished:
                continue
            req_id = slot_req[slot]
            if eng.sched.slot_request(slot) != req_id:
                continue  # finished before this block was dispatched
            tok = int(toks_np[j, slot])
            out[req_id].tokens.append(tok)
            eng.last_token[slot] = tok
            appended += 1
            is_eos = eng.eos_id is not None and tok == eng.eos_id
            if is_eos:
                out[req_id].finished_by_eos = True
            if eng.sched.record_token(slot, is_eos):
                eng._on_slot_finished(slot)
                finished.add(slot)
    eng.decode_tokens += appended
    # Tokens actually APPENDED this block (computed-but-discarded tail tokens
    # of mid-block finishers are excluded, consistent with decode_tokens).
    eng.events.append(("decode", appended))
    eng.decode_time_s += time.perf_counter() - t0


def run_decode_block(eng, active, out) -> None:
    """Advance every active slot by one decode BLOCK (host side).

    `eng` is either serving engine; both expose the same attribute surface
    (_dev/_dev_dirty device-resident sampling state, _decode_multi, scheduler,
    budgets) plus an `_on_slot_finished(slot)` hook for mid-block completion
    (EOS or budget): the dense engine just marks the device state dirty, the
    paged engine also releases the slot's pages. Tokens a finishing slot
    computed past its end are discarded at retirement — bounded waste, the
    standard trade-off for cutting per-token host round-trips.

    PIPELINED (eng.pipeline_decode): the next block is DISPATCHED before the
    previous block's tokens are read back, so the device-to-host readback
    of one block overlaps the device compute of the following block. Dispatches serialize on the donated caches, so
    device-side state is always exact; the host's view lags by at most one
    block. Consequences handled here:

      * budgets/capacity: _remaining/_cur_len are decremented at DISPATCH
        (scheduled semantics), so the next block's length bound never
        overshoots the cache;
      * membership changes (prefill completed, EOS found, slot released)
        need a host->device re-upload of sampling state built from
        last_token — which the in-flight block would stale-overwrite, so a
        dirty flag forces retirement FIRST;
      * a slot that finished while its next block was already in flight
        rides that block as a masked free lane; its extra tokens are
        dropped at retirement (dispatch-time slot->request snapshot).
    """
    if eng._dev_dirty:
        # Membership changed: the upload below must see the retired host
        # state, and the in-flight block's device tokens must not be lost.
        retire_decode_block(eng, out)
        active = eng.sched.active_slots()
        if not active:
            return
    t0 = time.perf_counter()
    if eng._dev_dirty:
        active_mask = np.zeros((eng.max_slots,), bool)
        active_mask[active] = True
        eng._dev = (
            jnp.asarray(eng.last_token),
            jnp.asarray(active_mask),
            jnp.asarray(eng._temps), jnp.asarray(eng._topk),
            jnp.asarray(eng._topp), jnp.asarray(eng._seeds),
        )
        # Exact static fast path: when every ACTIVE slot is greedy
        # (temperature 0), the block compiles without the sampling sorts.
        eng._dev_greedy = bool((eng._temps[active] == 0).all())
        eng._dev_dirty = False
    d_last, d_active, d_t, d_k, d_p, d_s = eng._dev
    # Block length: bounded by every active slot's SCHEDULED token budget and
    # cache headroom so no slot writes past its capacity mid-block — then
    # rounded DOWN to a power of two. k is a static arg of the jitted scan,
    # so each distinct value is a full XLA compile of the multi-layer decode
    # program; staggered budgets would otherwise walk k through arbitrary
    # values (7, 5, 3, ...), each a multi-second one-off stall. Pow2 rounding
    # caps the trace count at log2(decode_block_steps)+1.
    k_run = int(
        min(
            eng.decode_block_steps,
            min(eng._remaining[s] for s in active),
            min(eng.max_seq - eng._cur_len[s] for s in active),
        )
    )
    k_run = max(1, k_run)
    k_run = 1 << (k_run.bit_length() - 1)
    toks_dev, d_last, eng.caches = eng._decode_multi(
        eng.params, d_last, eng.caches, d_active,
        d_t, d_k, d_p, d_s, k_run, getattr(eng, "_dev_greedy", False),
    )
    eng._dev = (d_last, d_active, d_t, d_k, d_p, d_s)
    for s in active:
        eng._cur_len[s] += k_run
        eng._remaining[s] -= k_run
    eng.steps += k_run
    eng.decode_time_s += time.perf_counter() - t0
    next_pending = (
        toks_dev, list(active),
        {s: eng.sched.slot_request(s) for s in active},
    )
    if getattr(eng, "pipeline_decode", True):
        # Retire the PREVIOUS block now that this one is in flight: its
        # readback RTT overlaps this block's device execution.
        retire_decode_block(eng, out)
        eng._pending_block = next_pending
    else:
        eng._pending_block = next_pending
        retire_decode_block(eng, out)
