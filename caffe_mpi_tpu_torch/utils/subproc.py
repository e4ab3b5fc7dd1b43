"""Contained child processes for device work.

The port's own copy of the JAX package's `caffe_mpi_tpu/utils/subproc.py`.
A supervised training child holds the card. It runs in its own process
group, and the group is killed and the child reaped on every exit path of
the parent (a normal return, a deadline, an exception, SIGTERM, SIGINT or
SIGHUP): an orphan would keep the card's memory claimed, and an unreaped
zombie hides among the processes an operator looks through.
"""

from __future__ import annotations

import atexit
import os
import signal
import subprocess

# process groups of the live contained children: killed from atexit and
# from SIGTERM/SIGINT/SIGHUP, since a kill of the parent alone leaves a
# child in its own session running
_ACTIVE: set[int] = set()
_HOOKED = False


def _reap_all(signum=None, frame=None):
    for pgid in list(_ACTIVE):
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    if signum is not None:  # then the signal's default action
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def _install_hooks():
    global _HOOKED
    if _HOOKED:
        return
    _HOOKED = True
    atexit.register(_reap_all)
    for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
        try:
            signal.signal(sig, _reap_all)
        except (ValueError, OSError):  # not the main thread
            pass


def kill_all() -> None:
    """Kill every live contained child's group (a data-parallel worker
    died: its peers would wait in a collective until their timeout)."""
    _reap_all()


def run_contained(cmd: list[str], timeout: float | None,
                  env: dict | None = None,
                  echo: bool = False, tail_lines: int = 400):
    """Run `cmd` in its own process group with a deadline.

    Returns (returncode or None, stdout, stderr); None means the deadline
    expired. The group is killed with SIGKILL and the child reaped on
    every exit path, the parent's SIGTERM included.

    timeout=None sets no deadline (a supervised training child: its own
    dispatch watchdog bounds a hang, and a long run must not be cut by a
    fixed cap). echo=True copies the child's output to this process's
    stdout and stderr as it arrives and returns the last `tail_lines`
    lines of each, so memory stays bounded on a run that logs for hours.
    """
    _install_hooks()
    # block the handled signals from Popen to _ACTIVE.add: a SIGTERM in
    # that window would reap without knowing the new child and leave it
    # running. pthread_sigmask masks this thread only, so the window is
    # closed fully for a single-threaded caller.
    sigs = {signal.SIGTERM, signal.SIGINT, signal.SIGHUP}
    try:
        prev_mask = signal.pthread_sigmask(signal.SIG_BLOCK, sigs)
    except (ValueError, OSError):
        prev_mask = None
    try:
        proc = subprocess.Popen(cmd, env=env, text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE,
                                start_new_session=True)
        _ACTIVE.add(proc.pid)
    finally:
        if prev_mask is not None:
            signal.pthread_sigmask(signal.SIG_SETMASK, prev_mask)
    try:
        if echo:
            return _pump_echo(proc, timeout, tail_lines)
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        out, err = proc.communicate()  # drain the pipes, reap the child
        return None, out, err
    finally:
        _kill_group(proc)
        proc.wait()
        _ACTIVE.discard(proc.pid)


def _pump_echo(proc: subprocess.Popen, timeout: float | None,
               tail_lines: int):
    """Copy the child's pipes to this process's streams line by line,
    keeping a bounded tail of each. Returns (rc or None, out tail, err
    tail); None means the deadline expired and the group was killed."""
    import sys
    import threading
    from collections import deque

    tails = {"out": deque(maxlen=tail_lines), "err": deque(maxlen=tail_lines)}

    def pump(pipe, sink, key):
        for line in pipe:
            tails[key].append(line)
            sink.write(line)
            sink.flush()

    threads = [
        threading.Thread(target=pump, args=(proc.stdout, sys.stdout, "out"),
                         daemon=True),
        threading.Thread(target=pump, args=(proc.stderr, sys.stderr, "err"),
                         daemon=True),
    ]
    for t in threads:
        t.start()
    timed_out = False
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        timed_out = True
        _kill_group(proc)
        proc.wait()
    for t in threads:  # the pipes close once the group is dead
        t.join(timeout=5)
    return (None if timed_out else proc.returncode,
            "".join(tails["out"]), "".join(tails["err"]))


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
