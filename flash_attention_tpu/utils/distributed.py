"""Multi-host failure policy: init retries, fail-fast, and step watchdogs.

SURVEY.md §5 ("failure detection / recovery") promises the framework-level
policy the reference (a single-process benchmark) never needed: on a
multi-host GPU cluster, every host must join the same coordination barrier, and a host that
silently dies mid-step leaves every OTHER host blocked inside a collective
with no error. The policy here is the standard production recipe:

  * ``initialize_distributed`` — ``jax.distributed.initialize`` with bounded
    retries + exponential backoff (coordinator races at pod startup are
    routine, e.g. hosts scheduled seconds apart), then a device-count sanity
    check. Unrecoverable misconfiguration raises immediately.
  * ``fail_fast`` — wrap the step loop; any exception logs a one-line
    diagnosis and hard-exits the PROCESS (os._exit) so the coordinator can
    observe the death and peers fail their collectives promptly instead of
    hanging until the RPC timeout.
  * ``StepWatchdog`` — a daemon thread armed per step; if a step exceeds its
    deadline (hung collective, stuck DMA), it dumps all Python thread stacks
    to stderr and hard-exits. Re-arming each step keeps the common path to
    two atomic stores.

All three are inert in single-process use (tests drive them with mocks and
tiny deadlines; tests/test_distributed.py).
"""

from __future__ import annotations

import faulthandler
import os
import sys
import threading
import traceback
import time
from contextlib import contextmanager

import jax


class DistributedInitError(RuntimeError):
    """Raised when distributed initialization exhausts its retries."""


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    expected_local_devices: int | None = None,
    init_retries: int = 3,
    retry_delay_s: float = 2.0,
    backoff: float = 2.0,
    _initialize_fn=None,
) -> None:
    """``jax.distributed.initialize`` with retries, backoff, and validation.

    Args:
      coordinator_address, num_processes, process_id: forwarded to
        ``jax.distributed.initialize`` (all None = single-host autodetect,
        e.g. under a cluster launcher that sets the environment).
      expected_local_devices: if set, verify ``jax.local_device_count()``
        after init and raise DistributedInitError on mismatch (a host that
        came up with dead chips must die NOW, not at the first collective).
      init_retries: attempts before giving up.
      retry_delay_s, backoff: exponential backoff between attempts.
      _initialize_fn: test hook (defaults to ``jax.distributed.initialize``).
    """
    if init_retries < 1:
        raise ValueError(f"init_retries must be >= 1, got {init_retries}")
    init = _initialize_fn or jax.distributed.initialize
    delay = retry_delay_s
    last_err: Exception | None = None
    for attempt in range(1, init_retries + 1):
        try:
            kwargs = {}
            if coordinator_address is not None:
                kwargs["coordinator_address"] = coordinator_address
            if num_processes is not None:
                kwargs["num_processes"] = num_processes
            if process_id is not None:
                kwargs["process_id"] = process_id
            init(**kwargs)
            break
        except Exception as e:  # noqa: BLE001 — any init failure is retryable
            last_err = e
            if attempt == init_retries:
                raise DistributedInitError(
                    f"distributed init failed after {init_retries} attempts: "
                    f"{e!r}"
                ) from e
            print(
                f"[flash_attention_tpu] distributed init attempt "
                f"{attempt}/{init_retries} failed ({e!r}); retrying in "
                f"{delay:.1f}s",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
            delay *= backoff
    if expected_local_devices is not None:
        got = jax.local_device_count()
        if got != expected_local_devices:
            raise DistributedInitError(
                f"host came up with {got} local devices, expected "
                f"{expected_local_devices} — failing fast before the first "
                "collective hangs the pod"
            )
    if last_err is not None:
        print(
            "[flash_attention_tpu] distributed init succeeded after retry",
            file=sys.stderr,
            flush=True,
        )


@contextmanager
def fail_fast(context: str = "step loop", *, _exit_fn=None):
    """Hard-exit the process on any exception inside the block.

    On a pod slice, one host raising and unwinding normally leaves the other
    hosts blocked in collectives until RPC timeout (minutes). Exiting the
    process immediately lets the coordinator broadcast the failure and peers
    error out in seconds. KeyboardInterrupt exits with the conventional 130.
    """
    exit_fn = _exit_fn or os._exit
    try:
        yield
    except SystemExit:
        # An intentional sys.exit (clean shutdown or an explicit exit code)
        # is not a failure — let it unwind normally rather than converting
        # exit(0) into a FATAL hard-exit(1).
        raise
    except KeyboardInterrupt:
        print(
            f"[flash_attention_tpu] interrupted in {context}; exiting",
            file=sys.stderr,
            flush=True,
        )
        exit_fn(130)
    except BaseException as e:  # noqa: BLE001 — fail-fast means EVERYTHING
        print(
            f"[flash_attention_tpu] FATAL in {context}: {e!r} — "
            "hard-exiting so peer hosts fail their collectives promptly",
            file=sys.stderr,
            flush=True,
        )
        # The raised exception's own traceback first (os._exit never
        # unwinds, so this is the only record of the raise site);
        # dump_traceback below shows the OTHER threads' stacks.
        traceback.print_exc(file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr)
        exit_fn(1)


class StepWatchdog:
    """Detect hung steps (stuck collective / DMA) and kill the process.

    Usage::

        wd = StepWatchdog(deadline_s=300)
        for batch in data:
            with wd.step():
                loss = train_step(params, batch)
                jax.block_until_ready(loss)
        wd.close()

    The watchdog thread wakes every ``poll_s``; if the current step has been
    running longer than ``deadline_s``, it dumps all thread stacks and
    hard-exits (exit code 2). Between steps the timer is disarmed.
    """

    def __init__(
        self, deadline_s: float, *, poll_s: float | None = None, _exit_fn=None
    ):
        self.deadline_s = deadline_s
        self.poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 10.0)
        self._exit_fn = _exit_fn or os._exit
        self._armed_at: float | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.fired = False  # observable by tests (with a mock exit)
        self._thread = threading.Thread(
            target=self._run, name="fa-step-watchdog", daemon=True
        )
        self._thread.start()

    @contextmanager
    def step(self):
        with self._lock:
            self._armed_at = time.monotonic()
        try:
            yield
        finally:
            with self._lock:
                self._armed_at = None

    def _run(self):
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed = self._armed_at
            if armed is None:
                continue
            elapsed = time.monotonic() - armed
            if elapsed > self.deadline_s:
                self.fired = True
                print(
                    f"[flash_attention_tpu] step watchdog: step running "
                    f"{elapsed:.1f}s > deadline {self.deadline_s:.1f}s — "
                    "dumping stacks and hard-exiting",
                    file=sys.stderr,
                    flush=True,
                )
                faulthandler.dump_traceback(file=sys.stderr)
                self._exit_fn(2)
                return  # only reached with a mock exit (tests)

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)
