"""Typed flag/config registry (the port's own copy).

Counterpart of ``multiverso_tpu/utils/configure.py``, trimmed to what the
port calls: typed static registries keyed by string (string, int, double
and bool flags), ``MV_DEFINE_<type>(name, default, help)`` registration,
``HasFlag``,
``ParseCMDFlags`` stripping ``-key=value`` entries from argv (trying the
string, the int, the double, then the bool registry, reference
configure.cpp:24-41) and programmatic ``SetCMDFlag``. ``cached_flag`` and
its typed variants read a flag from a cache that change listeners refresh
(the telemetry gates consult theirs on every message).

The registry is this package's own, so a flag of the port can never clash
with a flag of the same name in the JAX package when both load in one
process.
"""

from __future__ import annotations

import threading
from typing import Dict, List

_lock = threading.RLock()

#: change listeners: fn(name_or_None) called after a flag value changes
#: (None = a bulk change, e.g. the reset to defaults). They let a hot path
#: read a flag from a cache (the telemetry gates) instead of taking the
#: registry lock on every call; a listener must be cheap and never raise.
_listeners: List = []


def register_flag_listener(fn) -> None:
    _listeners.append(fn)


def _notify(name) -> None:
    for fn in _listeners:
        fn(name)


def cached_flag(name: str, default, cast):
    """Zero-arg callable reading ``name`` through ``cast`` from a
    listener-refreshed cache, for per-message gates where a registry read
    per call costs too much. ``default`` applies while the flag is not
    registered."""
    state = {"v": default}

    def _refresh(changed=None):
        if changed is None or changed == name:
            try:
                state["v"] = cast(GetFlag(name))
            except Exception:
                state["v"] = default

    register_flag_listener(_refresh)
    _refresh()

    def _get():
        return state["v"]

    return _get


def cached_bool_flag(name: str, default: bool):
    return cached_flag(name, default, bool)


def cached_int_flag(name: str, default: int):
    return cached_flag(name, default, int)


def cached_float_flag(name: str, default: float):
    return cached_flag(name, default, float)


def cached_str_flag(name: str, default: str):
    """Lowercased-string variant: mode flags compare case-insensitively at
    every call site, so the fallback default rides the same cast as
    registry reads."""
    return cached_flag(name, str(default).lower(),
                       lambda v: str(v).lower())


class _FlagRegister:
    """One typed registry (reference configure.h:40-57 FlagRegister<T>)."""

    def __init__(self, caster):
        self.flags: Dict[str, object] = {}
        self.defaults: Dict[str, object] = {}
        self._caster = caster

    def register(self, name: str, default) -> None:
        with _lock:
            # re-registration keeps the existing value (tests re-import)
            self.flags.setdefault(name, default)
            self.defaults[name] = default
        _notify(name)

    def reset_to_defaults(self) -> None:
        with _lock:
            self.flags.update(self.defaults)

    def try_set(self, name: str, raw) -> bool:
        with _lock:
            if name not in self.flags:
                return False
            self.flags[name] = self._caster(raw)
        _notify(name)
        return True

    def get(self, name: str):
        with _lock:
            return self.flags[name]

    def has(self, name: str) -> bool:
        with _lock:
            return name in self.flags


def _cast_bool(raw) -> bool:
    if isinstance(raw, bool):
        return raw
    s = str(raw).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"not a bool: {raw!r}")


def _cast_int(raw) -> int:
    if isinstance(raw, bool):
        raise ValueError("bool is not int")
    return int(raw)


_string_flags = _FlagRegister(str)
_int_flags = _FlagRegister(_cast_int)
_double_flags = _FlagRegister(float)
_bool_flags = _FlagRegister(_cast_bool)

# lookup order matches the JAX package's ParseCMDFlags: string, int,
# double, then bool
_REGISTRIES = (_string_flags, _int_flags, _double_flags, _bool_flags)


def MV_DEFINE_string(name: str, default: str, help_text: str = "") -> None:
    """Define a string flag; ``help_text`` documents it at the call site."""
    _string_flags.register(name, default)


def MV_DEFINE_int(name: str, default: int, help_text: str = "") -> None:
    """Define an int flag; ``help_text`` documents it at the call site."""
    _int_flags.register(name, default)


def MV_DEFINE_double(name: str, default: float,
                     help_text: str = "") -> None:
    """Define a float flag; ``help_text`` documents it at the call site."""
    _double_flags.register(name, float(default))


def MV_DEFINE_bool(name: str, default: bool, help_text: str = "") -> None:
    """Define a bool flag; ``help_text`` documents it at the call site."""
    _bool_flags.register(name, default)


def GetFlag(name: str):
    """Read a flag from whichever registry holds it."""
    for reg in _REGISTRIES:
        if reg.has(name):
            return reg.get(name)
    raise KeyError(f"flag {name!r} was never defined")


def SetCMDFlag(name: str, value) -> None:
    """Programmatic flag set (reference MV_SetFlag)."""
    for reg in _REGISTRIES:
        if reg.has(name):
            reg.try_set(name, value)
            return
    raise KeyError(f"flag {name!r} was never defined")


def HasFlag(name: str) -> bool:
    """Whether any registry defines ``name``."""
    return any(reg.has(name) for reg in _REGISTRIES)


def ParseCMDFlags(argv: List[str] | None) -> List[str]:
    """Strip ``-key=value`` entries claimed by a registry; return the
    leftover argv (reference src/util/configure.cpp:9-55)."""
    remaining: List[str] = []
    for arg in argv or []:
        if arg.startswith("-") and "=" in arg:
            key, _, val = arg.lstrip("-").partition("=")
            consumed = False
            for reg in _REGISTRIES:
                try:
                    if reg.try_set(key, val):
                        consumed = True
                        break
                except ValueError:
                    continue   # registered here but unparseable: fall through
            if consumed:
                continue
        remaining.append(arg)
    return remaining


def ResetFlagsToDefaults() -> None:
    """Restore every flag to its registered default (MV_ShutDown calls
    this so one process can run successive worlds)."""
    for reg in _REGISTRIES:
        reg.reset_to_defaults()
    _notify(None)
