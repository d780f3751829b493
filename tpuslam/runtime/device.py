"""Where the program runs: the compile cache every entry point sets up, and
the device record every measurement is printed with."""
from __future__ import annotations

import os
import pathlib
import subprocess

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `JAX_COMPILATION_CACHE_DIR`
    when it is set, else at `<checkout>/.jax_cache`. Returns the directory.

    The path is fixed because it is part of the cache's key: a directory
    that moves between runs never hits. JAX decides once per process, at
    its first compilation, whether the cache is used, so call this before
    anything is compiled."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_record() -> dict:
    """The device as JAX reports it: platform, kind and count."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def nvidia_smi() -> str:
    """Name and power limit of each card, one line per card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them; a note in their place where nvidia-smi cannot be run."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                             check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip()
