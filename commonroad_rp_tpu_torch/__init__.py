"""commonroad_rp_tpu_torch — the reactive trajectory planner in PyTorch.

The PyTorch and CUDA port of ``commonroad_rp_tpu`` (the JAX package, which
stays the reference).  The planning cycle's candidate scoring runs as one
hand-written CUDA kernel for NVIDIA Hopper (``csrc/scoring.cu``, built with
nvcc on first use); on CPU tensors its plain PyTorch version runs instead.
This package imports ``torch`` and never ``jax``.

Subpackages
-----------
- ``models`` : planner facade, state types, sampling spaces, cost functions
- ``ops``    : polynomial, Frenet, scene compilation, rollout, the fused
               scorer and the planning cycle
- ``utils``  : config, geometry, scenario IO, route planning, profiling
"""

__version__ = "0.1.0"

from commonroad_rp_tpu_torch.utils.config import \
    ReactivePlannerConfiguration  # noqa: E402,F401


def __getattr__(name):
    # lazy, to keep a bare import cheap
    if name == "ReactivePlanner":
        from commonroad_rp_tpu_torch.models.planner import ReactivePlanner
        return ReactivePlanner
    raise AttributeError(name)
