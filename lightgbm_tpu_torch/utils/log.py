"""Leveled logging (reference include/LightGBM/utils/log.h:37-104).

The port's own copy of `lightgbm_tpu/utils/log.py`.

Levels mirror the reference LogLevel enum: Fatal=-1, Warning=0, Info=1,
Debug=2.  `Log.fatal` raises (reference log.h:76-90 throws
std::runtime_error); the active level is settable per-thread
(reference THREAD_LOCAL level, log.h:104) and maps from the `verbosity`
config param the same way the reference does (c_api.cpp maps
verbosity<0 -> Fatal, 0 -> Warning, 1 -> Info, >1 -> Debug).

A redirect callback supports the binding use-case (reference
Log::ResetCallBack used by the R/Python packages).

Multi-process attribution: while this process is a member of an
initialized `torch.distributed` group of more than one process (the
`machines` list, parallel/mesh.py), every line gets a ``[host k]``
prefix, k its rank, so the interleaved logs of a run stay attributable;
and every `Log.warning` counts into the telemetry registry
(``lgbm_log_warnings_total``), so a run's warning rate is readable even
when nobody is tailing stdout.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

LOG_FATAL = -1
LOG_WARNING = 0
LOG_INFO = 1
LOG_DEBUG = 2

_state = threading.local()
_callback: Optional[Callable[[str], None]] = None


def _host_tag() -> str:
    """``"[host k] "`` in a process group of more than one process, else
    "".  Read from torch only when it is already imported, and read on
    every line: a group joined by `Booster.set_network` may be freed
    again."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return ""
    dist = torch_mod.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return ""
    if dist.get_world_size() <= 1:
        return ""
    return f"[host {dist.get_rank()}] "


class LightGBMError(RuntimeError):
    """Raised by Log.fatal (the analog of the reference's
    std::runtime_error thrown from Log::Fatal)."""


class Log:
    @staticmethod
    def reset_level(level: int) -> None:
        _state.level = int(level)

    @staticmethod
    def level_from_verbosity(verbosity: int) -> int:
        if verbosity < 0:
            return LOG_FATAL
        if verbosity == 0:
            return LOG_WARNING
        if verbosity == 1:
            return LOG_INFO
        return LOG_DEBUG

    @staticmethod
    def get_level() -> int:
        return getattr(_state, "level", LOG_INFO)

    @staticmethod
    def reset_callback(cb: Optional[Callable[[str], None]]) -> None:
        global _callback
        _callback = cb

    @staticmethod
    def _write(level: int, tag: str, msg: str) -> None:
        if level > Log.get_level():
            return
        line = f"{_host_tag()}[LightGBM] [{tag}] {msg}\n"
        if _callback is not None:
            _callback(line)
        else:
            sys.stdout.write(line)
            sys.stdout.flush()

    @staticmethod
    def debug(msg: str) -> None:
        Log._write(LOG_DEBUG, "Debug", msg)

    @staticmethod
    def info(msg: str) -> None:
        Log._write(LOG_INFO, "Info", msg)

    @staticmethod
    def warning(msg: str) -> None:
        # counted before the verbosity filter, as in the JAX package: a
        # silenced run's warning rate stays readable in the registry
        from ..obs.metrics import REGISTRY

        REGISTRY.inc("lgbm_log_warnings_total",
                     help="Log.warning calls (pre-verbosity-filter)")
        Log._write(LOG_WARNING, "Warning", msg)

    @staticmethod
    def fatal(msg: str) -> None:
        Log._write(LOG_FATAL, "Fatal", msg)
        raise LightGBMError(msg)
