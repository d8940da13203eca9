"""Subprocess plumbing of the port's harnesses: run one command of
``python -m superresolution_aniso_mri_tpu_torch.cli`` as a child with
the data root in its environment, restart it on the watchdog's stall
status, and fail with the tails of its output.

Port of the JAX package's ``tools/_subproc.py``. The stall status is the
port's ``utils/watchdog.py::STALL_EXIT_CODE``; the child's device is a
flag of its command line (``--device``), so there is no CPU pin here.
"""
from __future__ import annotations

import os
import subprocess
import time

from ..utils.watchdog import STALL_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a stall-restart that dies again faster than this was never really
# running (import-time failure, a device gone for good)
_MIN_STALL_UPTIME_S = 30.0


def child_env(data_root: str) -> dict:
    """Environment of a child command: ``SR_DATA_ROOT`` and the repo on
    ``PYTHONPATH``."""
    return dict(
        os.environ, SR_DATA_ROOT=data_root,
        PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def run_child(cmd, data_root, what, log_path=None, timeout=7200,
              verbose=True, stall_restarts=0,
              min_stall_uptime_s=_MIN_STALL_UPTIME_S):
    """Run a child command in the repo; on failure raise SystemExit with
    the tails of its output (the whole of it goes to ``log_path`` when
    given).

    ``stall_restarts`` > 0 re-runs the child when it exits with the
    watchdog's stall status (75), up to that many times; the command
    should pass ``--auto_resume`` so that each attempt continues from
    the rolling checkpoint. Any other non-zero status fails at once, and
    two stalls in a row faster than ``min_stall_uptime_s`` end the loop
    (a dead device, not a transient wedge).

    ``timeout`` is the budget of the whole call, stall restarts and
    their back-off included, clamped to 7 days (``subprocess`` waits in
    int milliseconds and overflows past ~24.8 days). The log is
    truncated when the call starts and appended across its restarts.
    """
    if log_path:
        open(log_path, "w").close()
    timeout = min(timeout, 7 * 86400)
    deadline = time.time() + timeout
    attempts = 0
    fast_deaths = 0
    while True:
        remaining = deadline - time.time()
        if remaining <= 0:
            raise SystemExit(
                f"TIMEOUT [{what}]: overall {timeout:.0f}s budget "
                f"exhausted after {attempts} attempt(s): "
                f"{' '.join(cmd)}")
        r = _run_once(cmd, data_root, what, log_path, remaining)
        if r.returncode == STALL_EXIT_CODE and attempts < stall_restarts:
            fast_deaths = (fast_deaths + 1
                           if r.elapsed_s < min_stall_uptime_s else 0)
            if fast_deaths >= 2:
                print(f"[{what}] two consecutive "
                      f"sub-{min_stall_uptime_s:.0f}s stalls — the device "
                      f"looks dead, not wedged; giving up", flush=True)
                break
            attempts += 1
            # capped exponential back-off, deducted from the same budget;
            # when the budget is nearly spent, sleep just past it so the
            # next pass raises instead of starting a ~0 s attempt
            backoff = min(300.0, 5.0 * (2.0 ** max(0, attempts - 2)))
            print(f"[{what}] device stalled (exit {STALL_EXIT_CODE}) — "
                  f"restart {attempts}/{stall_restarts}"
                  + (f" (backoff {backoff:.0f}s)" if backoff > 5 else ""),
                  flush=True)
            time.sleep(min(backoff,
                           max(0.0, deadline - time.time()) + 0.1))
            continue
        break
    if r.returncode != 0:
        raise SystemExit(
            f"FAIL [{what}]: {' '.join(cmd)}\n{r.stdout[-2000:]}"
            f"\n{r.stderr[-4000:]}")
    if verbose:
        print(f"[{what}] done in {r.elapsed_s:.0f}s", flush=True)
    return r


def _text(out) -> str:
    return out.decode(errors="replace") if isinstance(out, bytes) \
        else (out or "")


def _run_once(cmd, data_root, what, log_path, timeout):
    t0 = time.time()
    try:
        r = subprocess.run(cmd, cwd=REPO, env=child_env(data_root),
                           capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired as e:
        # keep what the child printed before the hang, appended after
        # the earlier attempts' logs
        out, err = _text(e.stdout), _text(e.stderr)
        if log_path:
            with open(log_path, "a") as f:
                f.write(out + "\n--- stderr ---\n" + err
                        + f"\n--- TIMEOUT after {timeout}s ---\n")
        raise SystemExit(
            f"TIMEOUT [{what}] after {timeout}s: {' '.join(cmd)}\n"
            f"{out[-2000:]}\n{err[-4000:]}")
    if log_path:
        with open(log_path, "a") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    r.elapsed_s = time.time() - t0
    return r
