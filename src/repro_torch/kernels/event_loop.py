"""The circuit event loop compiled for the host (``csrc/event_loop_host.cpp``).

:func:`event_loop_compiled` runs the loop of the reference's
``repro.core.engine._event_loop`` in one foreign call, with its
establishment times bit for bit, and counts its own work;
``tests/test_torch_event_loop_compiled.py`` holds it to a numpy twin of
that loop and to the reference. The library is plain C++ built by the host
compiler on first use (``_build.load``, which raises where the build
fails); ``ctypes`` releases the GIL during the call.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import _build

__all__ = ["SOURCE", "entry", "event_loop_compiled"]

#: The source under ``csrc/``.
SOURCE = "event_loop_host"

# return codes of ``event_loop_host``
_OK, _DEADLOCK, _INVALID, _FAILED = 0, 1, 2, 3

_P = ctypes.c_void_p
_ARGTYPES = [ctypes.c_int64, _P, _P, _P, _P, ctypes.c_double, _P,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_int,
             _P, _P, _P, _P, _P]


@functools.cache
def entry():
    """The compiled loop's C entry point, built on first use."""
    fn = _build.load(SOURCE).event_loop_host
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    return fn


def _ptr(a: np.ndarray | None) -> int | None:
    return None if a is None else a.ctypes.data


def _vec(a, n: int, dtype, what: str) -> np.ndarray:
    """``a`` as a contiguous ``dtype`` array of ``n`` entries."""
    a = np.ascontiguousarray(a, dtype=dtype)
    if a.shape != (n,):
        raise ValueError(f"event loop: {what} has shape {a.shape}, "
                         f"not ({n},)")
    return a


def event_loop_compiled(rin, rout, srv, core, delta, n_res, n_ports, t0,
                        guard, release, free_in0, free_out0):
    """``(t_est, (events, tested, flows, visited, unread, unreleased))``
    of the compiled loop, with the arguments of the reference's
    ``repro.core.engine._event_loop``. ``events`` and ``flows`` are the
    numpy twin's, and so is ``tested`` under the guard; work-conserving,
    ``tested`` is the rows whose two resources the loop checked, once an
    event each, at most the twin's count. ``visited`` is the flow rows
    the loop read, finished ones included, ``unread`` the rows an event
    left behind its cursors on the lists it opened, and ``unreleased``
    the pending rows it read and passed because their release was still
    ahead (0 without ``release``). Ids are read as int64 and times as
    float64, the dtypes every caller passes.

    Raises the numpy loop's ``RuntimeError`` on a deadlock, and a
    ``ValueError`` for an id out of range, a NaN or a negative ``t0``.
    """
    fn = entry()
    F = np.shape(rin)[0]
    n_res, n_ports = int(n_res), int(n_ports)
    rin = _vec(rin, F, np.int64, "rin")
    rout = _vec(rout, F, np.int64, "rout")
    srv = _vec(srv, F, np.float64, "srv")
    core = _vec(core, F, np.int64, "core") if guard else None
    if np.ndim(delta) == 0:
        d, d_vec = float(delta), None
    else:
        d, d_vec = 0.0, _vec(delta, F, np.float64, "delta")
    if release is not None:
        release = _vec(release, F, np.float64, "release")
    if (free_in0 is None) != (free_out0 is None):
        raise ValueError("event loop: free_in0 and free_out0 are given "
                         "both or neither")
    if free_in0 is not None:
        free_in0 = _vec(free_in0, n_res, np.float64, "free_in0")
        free_out0 = _vec(free_out0, n_res, np.float64, "free_out0")
    t_est = np.empty(F)
    counts = np.zeros(6, dtype=np.int64)
    rc = fn(F, _ptr(rin), _ptr(rout), _ptr(srv), _ptr(core), d,
            _ptr(d_vec), n_res, n_ports, float(t0), int(bool(guard)),
            _ptr(release), _ptr(free_in0), _ptr(free_out0), _ptr(t_est),
            _ptr(counts))
    if rc == _DEADLOCK:
        raise RuntimeError("scheduler deadlock: pending flows but no events")
    if rc == _INVALID:
        raise ValueError("event loop: a resource or core id out of range, "
                         "a NaN, or a negative t0")
    if rc == _FAILED:
        raise MemoryError("event loop: could not allocate its state")
    return t_est, tuple(int(c) for c in counts)
