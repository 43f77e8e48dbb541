"""The one place that decides how the aligner uses the machine.

`use_device_path()` answers "accelerator path or CPU reference engine".
On a GPU the reference and each batch's reads live on the card, DP
windows are gathered there from descriptors, and one fused jit per
chunk returns only the compact traceback wire (ops/banded_sw.py
`_dp_tb_fused_gather`). On the CPU the XLA DP runs with the native host
traceback (ops/banded_sw.py `run_group_xla`): the plain reference
engine and the test engine. Nothing else in the package branches on the
platform.

`enable_compile_cache()` keeps JAX's persistent compilation cache at a
fixed path, so repeated runs skip the per-bucket compiles.
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def default_platform() -> str:
    """Platform new arrays and jit calls land on: the platform of the
    `jax.default_device` in effect (a Device or a platform name), else
    JAX's default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def use_device_path() -> bool:
    """True on a GPU (device-resident accelerator path), False on the
    CPU (XLA DP + native host traceback). Any other platform is an
    error, never a silent fallback."""
    platform = default_platform()
    if platform not in ("gpu", "cpu"):
        raise RuntimeError(f"unsupported JAX platform {platform!r}: "
                           f"lamsa_tpu runs on 'gpu' or 'cpu'")
    return platform == "gpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory. When JAX_COMPILATION_CACHE_DIR is set JAX reads it
    itself and nothing is set here; otherwise the cache lives at
    <repo>/.jax_cache (listed in .gitignore)."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
