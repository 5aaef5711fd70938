"""Shared CLI prologue for the pipeline tools.

Every tool is invoked as ``python -m ecckd_tpu.tools.<name> [key=value ...]
config.cfg`` (matching the reference executables,
doc/ecckd_documentation.tex:668-675) and begins with the same config/logging
setup (ref e.g. find_g_points.cpp:440-454).
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence, Tuple

from ..config import Config
from .. import logs

_search_path: List[str] = []


def prepend_search_directory(path: str):
    _search_path.insert(0, path)


def append_search_directory(path: str):
    _search_path.append(path)


def find_file(name: str) -> str:
    """Resolve a file name against the search path (ref file_manager.cpp)."""
    if os.path.isabs(name) or os.path.exists(name):
        return name
    for d in _search_path:
        candidate = os.path.join(d, name)
        if os.path.exists(candidate):
            return candidate
    return name


def tool_prologue(argv: Sequence[str]) -> Config:
    """Parse CLI args into a Config and apply log level / search path."""
    cfg = Config.from_args(list(argv))
    level = cfg.read_string("log_level", default=None)
    if level:
        logs.set_log_level(level)
    log_file = cfg.read_string("log_file", default=None)
    if log_file:
        logs.set_log_file(log_file)
    pp = cfg.read_string("prepend_path", default=None)
    if pp:
        prepend_search_directory(pp)
    ap = cfg.read_string("append_path", default=None)
    if ap:
        append_search_directory(ap)
    return cfg


def read_string_list(cfg: Config, key: str) -> List[str]:
    """Iterate a space-separated list the reference way (index until None)."""
    out = []
    i = 0
    while True:
        val = cfg.read_string(key, i, default=None)
        if val is None:
            break
        out.append(val)
        i += 1
    return out


class maybe_profile:
    """Context manager: write a jax.profiler trace when the ``profile_dir``
    config key is set (equivalent of the reference's Timer-based
    activity profiling, SURVEY.md §5)."""

    def __init__(self, cfg: Optional[Config]):
        self.trace_dir = (cfg.read_string("profile_dir", default=None)
                          if cfg is not None else None)

    def __enter__(self):
        if self.trace_dir:
            import jax
            jax.profiler.start_trace(self.trace_dir)
        return self

    def __exit__(self, *exc):
        if self.trace_dir:
            import jax
            jax.profiler.stop_trace()


# Root of the checkout: the fallback compile cache lives beside the package
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory:
    ``$JAX_COMPILATION_CACHE_DIR`` when that is set, otherwise
    ``<checkout>/.jax_cache``.  Returns the directory."""
    import jax
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def setup_jax(cfg: Optional[Config] = None):
    """Configure JAX for a pipeline tool: float64 by default (matching the
    reference's double precision), overridable with precision=float32 for
    device speed."""
    import jax
    precision = "float64"
    platform = None
    debug_nans = False
    if cfg is not None:
        precision = cfg.read_string("precision", default="float64")
        platform = cfg.read_string("jax_platform", default=None)
        debug_nans = cfg.read_bool("debug_nans", default=False)
    if platform:
        jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", precision == "float64")
    configure_compile_cache()
    if debug_nans:
        # Parity with the reference's enable_floating_point_exceptions()
        # (floating_point_exceptions.h:20-25, used by optimize_lut/scale_lut)
        jax.config.update("jax_debug_nans", True)
    return jax
