"""Which platform the device path runs on, and how its kernels run there.

The Pallas kernels are compiled for the GPU (the Triton route).  On the
CPU — tests, or `backend="jax"` forced on a host without a card — they
run in Pallas interpret mode.  No other platform has kernels, so asking
for one is an error rather than a silent fallback.
"""

import os

import jax

PLATFORMS = ("gpu", "cpu")


def platform():
    """The default device's platform: "gpu" or "cpu"; anything else
    raises."""
    name = jax.devices()[0].platform
    if name not in PLATFORMS:
        raise RuntimeError(
            f"the device path has no kernels for platform {name!r}: it "
            "runs on a GPU, or on the CPU in interpret mode")
    return name


def interpret_kernels():
    """True where the kernels run in interpret mode (the CPU), False
    where they are compiled (the GPU)."""
    return platform() == "cpu"


def use_compile_cache(root):
    """Keep JAX's persistent compile cache where JAX_COMPILATION_CACHE_DIR
    says when it is set (JAX reads it itself), else in `root`/.jax_cache.
    Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
