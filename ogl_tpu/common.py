"""Logging/timing utilities (reference common/common.{H,C}).

Leveled, field-aware log helpers (LOG_0/1/2 equivalents keyed on the
`verbose` config) and a wall-clock timing context that prints
`[OGL LOG] field: name: X [ms]` like TIME_WITH_FIELDNAME
(common.H:67-89).  The NVTX-range analogue is jax.profiler trace
annotations, emitted when a profiler trace is active.
"""

from __future__ import annotations

import contextlib
import os
import time

import jax

__all__ = ["log", "timed", "Timings", "compilation_cache_dir",
           "ensure_compilation_cache", "disable_compilation_cache"]


def log(verbose: int, level: int, msg: str) -> None:
    if verbose > level:
        print(f"[OGL LOG] {msg}")


class Timings(dict):
    """Accumulates named wall-clock timings in seconds."""


@contextlib.contextmanager
def timed(name: str, verbose: int = 0, field: str = "", sink: Timings | None = None):
    with jax.profiler.TraceAnnotation(name):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
    if sink is not None:
        sink[name] = sink.get(name, 0.0) + dt
    if verbose > 0:
        print(f"[OGL LOG] {field}: {name}: {dt * 1e3:.3f} [ms]")


_cache_set = False

# fixed, gitignored location inside the checkout: the cache key includes
# the directory, so a path that moves between runs never hits
_DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compilation_cache_dir() -> str:
    """Where the persistent compilation cache lives: JAX_COMPILATION_CACHE_DIR
    when the environment sets it, else `.jax_cache/` in the checkout."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_CACHE_DIR


def ensure_compilation_cache() -> None:
    """Enable jax's persistent compilation cache (cold first solves spend
    most of their time compiling; a warm cache removes it on later runs).

    When JAX_COMPILATION_CACHE_DIR is set, jax reads it itself and this
    sets nothing.  Otherwise the cache goes to `compilation_cache_dir()`.
    A directory the user already configured through jax.config wins."""
    global _cache_set
    if _cache_set:
        return
    _cache_set = True
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or \
            jax.config.jax_compilation_cache_dir:
        return
    path = compilation_cache_dir()
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return  # read-only checkout: run uncached
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def disable_compilation_cache() -> None:
    """Compile fresh in this process (no persistent cache reads or writes),
    e.g. for a run whose CPU cache entries may come from another host."""
    global _cache_set
    _cache_set = True
    jax.config.update("jax_compilation_cache_dir", None)
