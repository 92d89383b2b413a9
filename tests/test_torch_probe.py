"""The launch-overhead probe (``probes.t61_overhead``) and its kernel.

* ``scoring.trivial_probe_reference`` (the plain version of the probe
  kernel) against the TPU probe's ``pl.pallas_call`` of
  ``scripts/t61_overhead_probe.py:200-225`` in interpret mode: the kernel
  body is copied here (the script defines it inside ``main()``) and given
  the port's coefficient rows, table and obstacle rows, with its ``pair``
  and ``band`` operands as zeros (the port has no such stacks).  Results
  must be exactly equal.
* A CPU run of the probe (``--n-scan 3 --reps 1 --device cpu``) prints its
  three phases.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from commonroad_rp_tpu_torch.ops import scoring
from commonroad_rp_tpu_torch.probes import t61_overhead


def trivial_kernel(cl_ref, tab_ref, pair_ref, band_ref, obs_ref, out_ref):
    """scripts/t61_overhead_probe.py:200-203."""
    out_ref[:] = (cl_ref[0:1, :] + tab_ref[0, 0] + pair_ref[0, 0]
                  .astype(jnp.float32) + band_ref[0, 0]
                  .astype(jnp.float32) + obs_ref[0, 0, 0])


def _pallas_probe(cl, tab, obs, v, tile=256, W=256):
    """The probe's launch (:205-225) on these operands, interpret mode."""
    K = cl.shape[0]
    T = obs.shape[1]
    K_pad = ((K + tile - 1) // tile) * tile
    cl_p = jnp.pad(jnp.asarray(cl.T), ((0, 0), (0, K_pad - K)))
    pair = jnp.zeros((48, W), jnp.bfloat16)
    band = jnp.zeros((6, W), jnp.float32)
    with jax.enable_x64(False):
        out = pl.pallas_call(
            trivial_kernel,
            out_shape=jax.ShapeDtypeStruct((1, K_pad), jnp.float32),
            grid=(K_pad // tile,),
            in_specs=[
                pl.BlockSpec((6, tile), lambda i: (0, i),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((W, 12), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((48, W), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((6, W), lambda i: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, T, 7), lambda i: (0, 0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((1, tile), lambda i: (0, i),
                                   memory_space=pltpu.VMEM),
            interpret=True,
        )(cl_p + jnp.float32(v), jnp.asarray(tab), pair, band,
          jnp.asarray(obs[:1]))
    return np.asarray(out)[0, :K]


@pytest.mark.parametrize("seed", [0, 1])
def test_trivial_probe_matches_pallas_kernel(seed):
    rng = np.random.default_rng(seed)
    K, T, W = 700, 61, 256
    cl = rng.uniform(-50.0, 50.0, (K, 6)).astype(np.float32)
    tab = rng.uniform(-10.0, 200.0, (W, 12)).astype(np.float32)
    obs = rng.uniform(-5.0, 5.0, (2, T, 7)).astype(np.float32)
    v = np.float32(rng.uniform(15.0, 25.0))
    inp = scoring.ScorerInputs(
        coeffs_lon=torch.as_tensor(cl), coeffs_lat=torch.as_tensor(cl),
        traj_len=torch.full((K,), float(T)), goal_valid=torch.ones(K),
        table=torch.as_tensor(tab), obs=torch.as_tensor(obs),
        poly=torch.zeros((0, T, 3)), scalars=torch.zeros(17), n_steps=T - 1,
        n_poly_verts=1, flags=0)
    v_t = torch.tensor(v)
    want = _pallas_probe(cl, tab, obs, v)
    np.testing.assert_array_equal(scoring.trivial_probe_reference(
        inp, v_t).numpy(), want)
    # the CPU wrapper is the plain version; without obstacles obs0 is 0
    np.testing.assert_array_equal(scoring.trivial_probe(inp, v_t).numpy(),
                                  want)
    empty = inp._replace(obs=torch.zeros((0, T, 7)))
    np.testing.assert_array_equal(
        scoring.trivial_probe(empty, v_t).numpy(),
        _pallas_probe(cl, tab, np.zeros((1, T, 7), np.float32), v))


def test_probe_runs_on_the_cpu(capsys):
    assert t61_overhead.main(["--n-scan", "3", "--reps", "1",
                              "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("K=8874 T=61 n_scan=3 device=cpu")
    phases = [line.split(":")[0].strip() for line in lines[1:]]
    assert phases == ["A full scorer call", "C operand layout only",
                      "D trivial kernel"]
    for line in lines[1:]:
        assert "us/launch" in line and "M cands/s" in line
