"""Failure detection + elastic training-loop recovery.

The reference has nothing here (SURVEY.md §5: "none") — a crashed run
loses everything since the last manual save. This module supplies the
minimum a production training loop needs:

  * :func:`device_healthy` — a bounded liveness probe (a trivial op with
    a wall-clock deadline, run in a daemon thread so a WEDGED runtime —
    where even ``jnp.ones`` never returns — cannot hang the caller).
  * :func:`run_elastic` — drive a jitted step function with periodic
    orbax checkpoints (``utils.checkpoint``) and automatic
    restore-and-resume after a step raises: the state rolls back to the
    last checkpoint, the step re-jits (a fresh client can re-establish
    a recovered runtime), and the loop continues — bounded by
    ``max_restarts``.

Design notes (why this shape):
  * Failure detection is HOST-side: XLA gives no per-step device
    callbacks, and a dead/wedged device manifests as a hung or raising
    host call — so the probe is a deadline, not a query.
  * Recovery is CHECKPOINT-based, not replica-based: on a single-
    controller JAX runtime the controller owns all state; peer-to-peer
    state reconstruction (the elastic-horovod model) is not needed.
    dp/tp/sp reshape-on-resume falls out of
    orbax restore-into-NamedSharding (``checkpoint.restore_checkpoint``
    with a ``like`` tree sharded over the NEW mesh).
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Any, Callable, Optional

__all__ = ["device_healthy", "ElasticState", "run_elastic"]


def device_healthy(timeout_s: float = 30.0) -> bool:
    """True iff a trivial device computation completes within the
    deadline. Runs in a daemon thread: a wedged runtime (a hung compile
    or device) leaves the thread blocked without hanging the caller."""
    ok = [False]

    def probe():
        try:
            import jax
            import jax.numpy as jnp

            x = jnp.ones((8, 128))
            ok[0] = bool(abs(float((x @ x.T).sum()) - 8192.0) < 1e-3)
        except Exception:
            ok[0] = False

    t = threading.Thread(target=probe, daemon=True)
    t.start()
    t.join(timeout_s)
    return ok[0]


class ElasticState:
    """Result of :func:`run_elastic`: final state + failure accounting."""

    def __init__(self, state, step: int, restarts: int, failures: list):
        self.state = state
        self.step = step
        self.restarts = restarts
        self.failures = failures


def run_elastic(
    step_fn: Callable[[Any, int], Any],
    state: Any,
    n_steps: int,
    *,
    checkpoint_every: int = 100,
    checkpoint_dir: Optional[str] = None,
    max_restarts: int = 3,
    health_timeout_s: float = 60.0,
    on_failure: Optional[Callable[[int, BaseException], None]] = None,
) -> ElasticState:
    """Run ``state = step_fn(state, t)`` for ``t in range(n_steps)`` with
    periodic checkpoints and automatic rollback-and-resume on failure.

    On an exception from ``step_fn``: the failure is recorded, the
    device is health-probed (bounded), the state restores from the last
    checkpoint, and the loop resumes from that step. More than
    ``max_restarts`` failures (or a failed health probe after the
    restart budget is spent) re-raises the last error. ``step_fn`` must
    be a pure state transition (the jitted train step + host schedule);
    checkpoints go through the dtype-preserving orbax layer.
    """
    from . import checkpoint as ckpt

    if checkpoint_dir is None:
        checkpoint_dir = tempfile.mkdtemp(prefix="sputnik_elastic_")
    path = os.path.join(checkpoint_dir, "elastic")

    def save(state, t):
        ckpt.save_checkpoint(path, {"state": state, "step": t})

    save(state, 0)
    last_saved = 0
    restarts = 0
    failures: list = []
    t = 0
    while t < n_steps:
        try:
            state = step_fn(state, t)
            t += 1
            if t % checkpoint_every == 0 and t < n_steps:
                save(state, t)
                last_saved = t
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — device loss is broad
            failures.append((t, repr(e)))
            if on_failure is not None:
                on_failure(t, e)
            restarts += 1
            if restarts > max_restarts:
                raise
            # a failed probe consumes further restart budget (bounded
            # waits) instead of aborting: a transient wedge that recovers
            # within minutes is exactly what the budget is for
            while not device_healthy(health_timeout_s):
                restarts += 1
                failures.append((t, "health probe timeout"))
                if restarts > max_restarts:
                    raise
            blob = ckpt.restore_checkpoint(
                path, like={"state": state, "step": 0})
            state, t = blob["state"], int(blob["step"])
            # roll forward from the restore point; nothing past
            # last_saved survived, by design
            assert t == last_saved
    return ElasticState(state, t, restarts, failures)
