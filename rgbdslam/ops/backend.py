"""The one place that maps the JAX platform to an implementation.

Each hand-written kernel in ops/pallas_kernels.py has a plain JAX reference
beside it. This table says which of the two runs where; a platform missing
from it is an error, never a silent fallback to the reference or to the
Pallas interpreter. Also the --platform choice of the entry points.
"""

from __future__ import annotations

import jax

# platform (jax.default_backend()) -> op -> implementation
KERNELS = {
    "cpu": {"gicp": "xla"},
    "gpu": {"gicp": "triton"},
}

# op -> the largest problem a compiled kernel takes; above it the plain
# reference runs. The GICP kernel keeps every point's planes in one CTA's
# registers; on an H100 it beats the XLA loop up to 4096 points (0.35 vs
# 0.74 ms there), the system's feature ceiling; larger is not measured
# (PERF.md, Findings).
KERNEL_MAX_SIZE = {"gicp": 4096}

PLATFORMS = ("auto", "cpu", "gpu")


def current_platform() -> str:
    """Platform new computations land on: the ``jax.default_device``
    override when one is active, else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    platform = getattr(dev, "platform", dev)
    return "gpu" if platform in ("cuda", "rocm") else platform


def kernel_impl(op: str, platform: str | None = None, *, size: int) -> str:
    """Implementation of `op` ('gicp') over `size` elements (GICP: points)
    on `platform` (default: current_platform()): 'triton' for the Pallas
    kernel compiled for the GPU, 'xla' for the plain reference."""
    if platform is None:
        platform = current_platform()
    if platform not in KERNELS:
        raise RuntimeError(
            f"no kernel choice for platform {platform!r}; known: "
            f"{sorted(KERNELS)}")
    impl = KERNELS[platform][op]
    if impl != "xla" and size > KERNEL_MAX_SIZE[op]:
        return "xla"
    return impl


def select_platform(name: str) -> None:
    """Pin the JAX platform before the first backend use.

    'auto' keeps JAX's own choice (the GPU when one is visible), 'cpu' forces
    the host, 'gpu' insists on a GPU and raises when none is visible.
    """
    if name not in PLATFORMS:
        raise ValueError(f"platform {name!r} not in {PLATFORMS}")
    if name == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif name == "gpu":
        try:
            jax.devices("gpu")
        except RuntimeError as e:
            raise RuntimeError("--platform gpu: no GPU is visible to JAX") \
                from e
