"""Step-stall watchdog: failure DETECTION for hung device work.

A copy of ``superresolution_aniso_mri_tpu/utils/watchdog.py``. A stalled
device (a wedged driver, a lost card) does not raise in the host
process: the next blocking device call never returns, and a training job
silently burns its reservation. The recovery contract is process-level:
DETECT the stall, exit with a distinctive status, and let the supervisor
restart the job with ``--auto_resume`` picking up the rolling
``last.models`` checkpoint (written every epoch, train/trainer.py).

Usage (wired into cli/train_loop.run_training via --step_timeout_s, and
into the serving daemon via --synth_timeout_s):

    wd = StepWatchdog(timeout_s=300)
    wd.start()
    for batch in batches:
        trainer.train(batch)
        wd.beat()            # progress heartbeat
    with wd.suspended():     # host-side phases with no device traffic
        write_checkpoints()
    wd.stop()

A Python-level timeout cannot cancel a hung device call, so the only safe
action is ``os._exit`` — skipping interpreter teardown that would itself
block on the dead device. Exit status 75 (EX_TEMPFAIL) marks "transient
infrastructure failure, retry me" for supervisor loops:

    while true; do
        python -m superresolution_aniso_mri_tpu_torch.cli train-brain \\
            ... --auto_resume --step_timeout_s 300
        [ $? -eq 75 ] || break   # 75 = stall-killed, restart; else done
    done
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from typing import Callable, Optional

#: exit status used when a stall is detected (EX_TEMPFAIL: tell the
#: supervisor this is transient and the job should be restarted)
STALL_EXIT_CODE = 75


def _default_on_stall(elapsed_s: float, beats: int, label: str) -> None:
    sys.stderr.write(
        f"\n*** StepWatchdog{f' [{label}]' if label else ''}: no progress "
        f"heartbeat for {elapsed_s:.0f}s after {beats} beats — the device "
        f"appears hung.\n"
        f"*** Exiting with status {STALL_EXIT_CODE} so a supervisor can "
        f"restart with --auto_resume (rolling last.models checkpoint).\n")
    sys.stderr.flush()
    # os._exit, not sys.exit: interpreter teardown (atexit handlers,
    # the device runtime's destructors) can itself block forever on the
    # dead device
    os._exit(STALL_EXIT_CODE)


class StepWatchdog:
    """Daemon-thread heartbeat monitor.

    ``beat()`` marks progress; if no beat arrives for ``timeout_s`` while
    the watchdog is armed, ``on_stall(elapsed_s, beats, label)`` runs
    (default: diagnostic + ``os._exit(75)``). ``suspended()`` disarms it
    around host-only phases (checkpoint IO, metric dumps) whose duration
    is unrelated to device health.

    Until the FIRST beat, the window is ``first_timeout_s`` (default
    ``timeout_s``): the first step of a process carries one-off start-up
    work (kernel builds, cuDNN algorithm selection, data loading), so
    sizing the steady-state window for it would blunt stall detection —
    and sizing it for steps kills healthy processes during warm-up, a
    restart LOOP when the supervisor's --auto_resume child pays the same
    start-up again.
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[float, int, str], None]] = None,
                 poll_s: float = 2.0, label: str = "",
                 first_timeout_s: Optional[float] = None):
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.first_timeout_s = (float(first_timeout_s)
                                if first_timeout_s else self.timeout_s)
        if self.first_timeout_s < self.timeout_s:
            raise ValueError(
                f"first_timeout_s ({self.first_timeout_s}) must be >= "
                f"timeout_s ({self.timeout_s}) — the warm-up window can "
                f"only be more lenient")
        self.poll_s = min(float(poll_s), self.timeout_s / 2.0)
        self.label = label
        self._on_stall = on_stall or _default_on_stall
        self._lock = threading.Lock()
        self._last_beat = time.monotonic()
        self._beats = 0
        self._armed = False
        self._stop = threading.Event()
        self._fired = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------
    def start(self) -> "StepWatchdog":
        if self._thread is not None:
            raise RuntimeError("watchdog already started")
        self._stop.clear()  # allow stop() → start() reuse
        self._fired = False
        with self._lock:
            self._last_beat = time.monotonic()
            self._armed = True
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="sr-step-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_s * 4)
            self._thread = None

    # -- progress / arming -------------------------------------------
    def beat(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._beats += 1

    def pause(self) -> None:
        with self._lock:
            self._armed = False

    def resume(self) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            self._armed = True

    @contextlib.contextmanager
    def suspended(self):
        """Disarm inside host-only phases; re-arms (with a fresh window)
        on exit even if the body raises."""
        self.pause()
        try:
            yield self
        finally:
            self.resume()

    # -- monitor loop ------------------------------------------------
    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                armed = self._armed
                elapsed = time.monotonic() - self._last_beat
                beats = self._beats
            window = self.timeout_s if beats else self.first_timeout_s
            if armed and elapsed > window and not self._fired:
                self._fired = True
                self._on_stall(elapsed, beats, self.label)
                return
