"""The persistent XLA compilation cache, in one place.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and this
module sets nothing.  Otherwise, when the package runs from a source
checkout (``pyproject.toml`` beside the package), the cache lives at a fixed
``.jax_cache`` directory in the checkout, so every process of the repo
(library calls, ``bench.py``, ``chip_smoke.py``, the scripts under
``benchmarks/``) shares one cache whose path never moves.  An installed
package sets no cache.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
PACKAGE_DIR = Path(__file__).resolve().parents[1]


def checkout_cache(package_dir: Path = PACKAGE_DIR) -> Optional[Path]:
    """``<checkout>/.jax_cache`` when ``package_dir`` sits in a source
    checkout, None for an installed package (site-packages)."""
    root = package_dir.parent
    return root / ".jax_cache" if (root / "pyproject.toml").is_file() else None


CHECKOUT_CACHE = checkout_cache()


def cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The compile-cache directory this process should use (None: none)."""
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    return None if CHECKOUT_CACHE is None else str(CHECKOUT_CACHE)


def ensure_compile_cache() -> Optional[str]:
    """Point JAX at :func:`cache_dir` unless the environment variable or the
    process already chose a directory.  Returns the directory in use, or
    None when there is none (an installed package, or a checkout directory
    that cannot be created)."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    path = cache_dir()
    if path is None:
        return None
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    jax.config.update("jax_compilation_cache_dir", path)
    return path
