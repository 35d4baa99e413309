"""Shutdown callbacks on SIGINT/SIGTERM: the port's own copy of
``k8s_tpu/util/signals.py``'s ``on_shutdown`` (the trainer's cooperative
preemption hook), with a plain ``threading.Lock``.

The first signal sets a latch and runs every registered callback; a second
one exits the process with code 1 (the reference's double-signal
contract).  Unsubscribing the last callback restores the signal handlers
that were there before.
"""

from __future__ import annotations

import os
import signal
import threading

_lock = threading.Lock()
_installed = False
_callbacks: list = []
_stop = threading.Event()
_prev_handlers: dict = {}


def _handler(signum, frame):  # noqa: ARG001
    if _stop.is_set():
        os._exit(1)  # second signal: exit directly
    _stop.set()
    for cb in list(_callbacks):
        try:
            cb()
        except Exception:  # noqa: BLE001 - the shutdown path must not raise
            pass


def _install() -> None:
    global _installed
    _installed = True
    _prev_handlers[signal.SIGINT] = signal.signal(signal.SIGINT, _handler)
    _prev_handlers[signal.SIGTERM] = signal.signal(signal.SIGTERM, _handler)


def _uninstall() -> None:
    global _installed
    _installed = False
    for sig, prev in _prev_handlers.items():
        signal.signal(sig, prev)
    _prev_handlers.clear()


def on_shutdown(callback):
    """Register ``callback`` to run on the first SIGINT/SIGTERM (before the
    double-signal hard-exit window), installing the shared handler if no
    one has yet.  Call from the main thread.  Returns an unsubscribe
    callable."""
    with _lock:
        if not _callbacks:
            # a fresh run: clear the latch a consumed signal of an earlier
            # run left, else this run's first SIGTERM would hard-exit
            _stop.clear()
        _callbacks.append(callback)
        if not _installed:
            _install()

    def unsubscribe() -> None:
        with _lock:
            try:
                _callbacks.remove(callback)
            except ValueError:
                pass
            if not _callbacks and _installed:
                _uninstall()

    return unsubscribe
