"""The buffered form of the three replanning scans and of the XLA fleet
rollout (``ScanProgram``) on the CPU: the form a CUDA graph captures, run
eagerly.

* Bit for bit (``torch.equal``, same dtype) the loop it replaced: the
  cycle run in a Python loop with the metrics stacked after it, for the
  facade scan behind ``plan_scan`` (ZAM_Over-1_1, 3 cycles), the fleet scan
  (the 12-problem heterogeneous fleet, 2 cycles) and the single-problem
  scan (ZAM_Over-1_1, 3 cycles); for the XLA fleet rollout
  (``parallel.fleet.make_fleet_rollout``, the same fleet at sampling level
  1, 2 cycles) the fleet step on the caller's scene in a Python loop.
* A built program run a second time, from another carry and (facade) at
  another desired speed or (XLA rollout) on another scene of the same
  shapes, equals a fresh build bit for bit: no static state survives a
  call, and a rollout reads the scene of its call, not the first call's.
  A scene or carry whose field differs in shape or dtype raises.
* One cycle of each program under a ``TorchDispatchMode`` records no op
  that a capture forbids: no device read (``_local_scalar_dense``), no
  data-dependent shape (``nonzero``, ``masked_select``, a boolean index),
  no host data turned into a tensor (``lift_fresh``) and no copy between
  devices.

The JAX parity of the scans is held by ``tests/test_torch_fleet.py`` and
``tests/test_torch_plan_scan.py``, which run through the same programs.
"""

import functools
import logging

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from commonroad_rp_tpu_torch.ops import grid, program
from commonroad_rp_tpu_torch.parallel import fleet
from commonroad_rp_tpu_torch.run_fleet import (DT, N_STEPS,
                                               heterogeneous_fleet, make_scan)
from commonroad_rp_tpu_torch.run_planner import load_config, make_planner

logging.getLogger("RP_LOGGER").setLevel(logging.CRITICAL)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _facade(repo_root, n_cycles, graph=True):
    planner = make_planner(load_config("ZAM_Over-1_1", repo_root), "cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    run, carry = planner.scan_program(n_cycles, graph=graph)
    return run, carry, float(planner._desired_speed)


@functools.lru_cache(maxsize=None)
def _fleet_scene(seed=0):
    """The 12-problem fleet's scene and carry (read, never written, by the
    programs); another seed jitters the same bases into a scene of the same
    shapes."""
    return heterogeneous_fleet(12, 2, seed=seed, device="cpu")[:2]


XLA_KW = dict(replan_offset=1, low_vel_threshold=4.0, horizon=N_STEPS * DT)


def _xla_grid():
    return grid.make_static_grid(1, 0.4, N_STEPS * DT, DT, -3.0, 3.0, 4)


def _xla(n_cycles, graph=True):
    """The XLA fleet rollout of run_fleet --xla at sampling level 1 (each
    problem's own vehicle) over the 12-problem fleet."""
    scene, carry = _fleet_scene()
    run = fleet.make_fleet_rollout(None, None, _xla_grid(), DT, N_STEPS,
                                   n_cycles=n_cycles, device="cpu",
                                   graph=graph, **XLA_KW)
    return run, carry, (scene,)


def _fleet(n_cycles):
    scene, carry = _fleet_scene()
    return make_scan(scene, n_cycles)[0], carry


def _single(n_cycles):
    return chip_smoke.single_problem_scan(torch, n_cycles, "cpu")


def _stacked_loop(cycle, carry, n_cycles):
    """The loop the buffered form replaced: the carry passed from cycle to
    cycle, the metrics stacked after the loop."""
    metrics = []
    for _ in range(n_cycles):
        carry, m = cycle(carry)
        metrics.append(m)
    return carry, tuple(torch.stack(column) for column in zip(*metrics))


def _assert_identical(got, want):
    (carry_g, metrics_g), (carry_w, metrics_w) = got, want
    assert type(carry_g) is type(carry_w)
    for name, g, w in zip(carry_w._fields, carry_g, carry_w):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert len(metrics_g) == len(metrics_w)
    for i, (g, w) in enumerate(zip(metrics_g, metrics_w)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g.nan_to_num(), w.nan_to_num()), i
        assert torch.equal(g.isnan(), w.isnan()), i


def _program(repo_root, which, n_cycles=None):
    """(run, carry, run arguments) of one of the three scans: 3 cycles of
    the facade and the single-problem scan, 2 of the fleet scan."""
    if which == "facade":
        run, carry, ds = _facade(repo_root, n_cycles or 3)
        return run, carry, (ds,)
    if which == "fleet":
        return (*_fleet(n_cycles or 2), ())
    if which == "xla":
        return _xla(n_cycles or 2)
    return (*_single(n_cycles or 3), ())


def _other_args(which, args):
    """Another call's arguments: a desired speed 2 m/s higher (facade),
    another scene of the same shapes (XLA rollout)."""
    if which == "facade":
        return (args[0] + 2.0,)
    if which == "xla":
        return (_fleet_scene(seed=1)[0],)
    return ()


SCANS = ["facade", "fleet", "single"]
PROGRAMS = SCANS + ["xla"]


@pytest.mark.parametrize("which", SCANS)
def test_buffered_form_equals_stacked_loop(repo_root, which):
    run, carry, args = _program(repo_root, which)
    assert not run.graph and run.replays == 0
    got = run(carry, *args)
    # the facade's cycle reads the desired speed the call above wrote
    want = _stacked_loop(run.cycle, carry, run.n_cycles)
    _assert_identical(got, want)
    assert run.replays == 0


def test_xla_rollout_equals_stacked_steps():
    """The XLA rollout against the form it replaced: the fleet step on the
    caller's scene in a Python loop, each metric stacked after it."""
    run, carry, (scene,) = _xla(2)
    assert not run.graph and run.replays == 0
    got = run(carry, scene)
    step = fleet.make_fleet_step(None, None, _xla_grid(), DT, N_STEPS,
                                 device="cpu", **XLA_KW)
    want = _stacked_loop(lambda c: step(c, scene), carry, 2)
    _assert_identical(got, want)
    assert isinstance(got[1], fleet.CycleMetrics)
    assert got[1].found.shape == (2, 12) and bool(got[1].found[0].all())


@pytest.mark.parametrize("which", PROGRAMS)
def test_second_call_equals_fresh_build(repo_root, which):
    run, carry, args = _program(repo_root, which)
    first_carry, first_metrics = run(carry, *args)
    kept = (first_carry._replace(**{f: getattr(first_carry, f).clone()
                                    for f in first_carry._fields}),
            tuple(m.clone() for m in first_metrics))
    # another carry (where the first call ended) and another speed or scene
    args2 = _other_args(which, args)
    second = run(first_carry, *args2)
    fresh = _program(repo_root, which)[0]
    _assert_identical(second, fresh(first_carry, *args2))
    # what the first call returned is the caller's: the second call did
    # not write into it
    _assert_identical((first_carry, first_metrics), kept)


def test_xla_rollout_reads_each_calls_scene():
    """One built rollout called on two scenes of the same shapes gives each
    scene's own result, and the first scene's again after the second."""
    run, carry, (scene,) = _xla(1)
    other = _other_args("xla", (scene,))[0]
    first = run(carry, scene)
    second = run(carry, other)
    assert not torch.equal(first[1].best_cost, second[1].best_cost)
    _assert_identical(second, _xla(1)[0](carry, other))
    _assert_identical(run(carry, scene), first)


def test_xla_rollout_scene_layout_is_fixed_at_the_first_call():
    run, carry, (scene,) = _xla(1)
    run(carry, scene)
    with pytest.raises(ValueError, match="scene field desired_speed"):
        run(carry, scene._replace(desired_speed=scene.desired_speed.double()))
    with pytest.raises(ValueError, match="scene field obs_pose"):
        run(carry, scene._replace(obs_pose=scene.obs_pose[:, :, 1:]))
    with pytest.raises(ValueError, match="scene field ref.s"):
        run(carry, scene._replace(ref=scene.ref._replace(
            s=scene.ref.s[:, 1:])))


class CaptureForbidden(TorchDispatchMode):
    """Records every op that a CUDA graph capture forbids or silently
    freezes: device reads, data-dependent shapes, host data turned into a
    tensor, copies between devices."""

    NAMES = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
             "_unique", "_unique2", "unique_consecutive", "lift_fresh",
             "lift_fresh_copy")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name in self.NAMES:
            self.seen.append(str(func))
        elif name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            indices = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in indices):
                self.seen.append(f"{func} with a boolean index")
        elif name in ("_to_copy", "copy_", "to"):
            src = args[1] if name == "copy_" else args[0]
            dst = args[0].device if name == "copy_" else (
                kwargs.get("device") or src.device)
            if isinstance(src, torch.Tensor) and torch.device(dst) != \
                    src.device:
                self.seen.append(f"{func} from {src.device} to {dst}")
        return func(*args, **kwargs)


def test_forbidden_op_recorder_is_sensitive():
    x = torch.arange(6.0)
    for fn in (lambda: x[0].item(), lambda: bool(x[1] > 0),
               lambda: torch.nonzero(x), lambda: x[x > 2],
               lambda: torch.tensor([1.0, 2.0]),
               lambda: x.clone().masked_fill_(x > 2, 0.0).masked_select(
                   x > 1)):
        with CaptureForbidden() as rec:
            fn()
        assert rec.seen, fn
    with CaptureForbidden() as rec:
        torch.where(x > 2, 0.0, x).index_copy_(
            0, torch.zeros((), dtype=torch.int64), x[:1])
    assert rec.seen == []


@pytest.mark.parametrize("which", PROGRAMS)
def test_one_cycle_has_no_capture_forbidden_op(repo_root, which):
    run, carry, args = _program(repo_root, which, n_cycles=1)
    run(carry, *args)    # allocates the static buffers
    with CaptureForbidden() as rec:
        run(carry, *args)
    assert rec.seen == [], rec.seen


def test_graph_is_taken_only_where_the_device_allows(repo_root):
    """``graph=True`` asks for a capture where the device allows one: on
    the CPU every program runs eagerly, a scan under a process group too
    (the device decides, not the group: on the card the fleet scan under an
    NCCL group captures its all-reduces), and the facade's cache keys the
    flag, so the default and an explicit ``True`` share one built
    program."""
    run, _, _ = _facade(repo_root, 1, graph=True)
    assert not run.graph
    assert not make_scan(_fleet_scene()[0], 1, mesh=object(),
                         graph=True)[0].graph
    assert not _xla(1, graph=True)[0].graph
    planner = make_planner(load_config("ZAM_Over-1_1", repo_root), "cpu")
    planner.set_desired_velocity(current_speed=planner.x_0.velocity)
    assert planner.scan_program(1)[0] is planner.scan_program(
        1, graph=True)[0]
    assert planner.scan_program(1)[0] is not planner.scan_program(
        1, graph=False)[0]


def test_carry_layout_is_fixed_at_the_first_call():
    run, carry = _single(1)
    run(carry)
    with pytest.raises(ValueError, match="carry field velocity"):
        run(carry._replace(velocity=carry.velocity.double()))
    assert isinstance(run, program.ScanProgram)


@pytest.mark.parametrize("which", PROGRAMS)
def test_observed_carries_equal_a_chain_of_one_cycle_calls(repo_root, which):
    """The public per-cycle read of a scan's carry: ``observe`` sees, after
    each cycle, the carry a chain of one-cycle calls of the same program
    gives, bit for bit, and observing changes nothing the call returns."""
    run, carry, args = _program(repo_root, which)
    seen = []
    got = run(carry, *args, observe=lambda c: seen.append(
        type(c)(*(x.clone() for x in c))))
    assert len(seen) == run.n_cycles
    _assert_identical(got, run(carry, *args))
    one = _program(repo_root, which, n_cycles=1)[0]
    chained = carry
    for observed in seen:
        chained, _ = one(chained, *args)
        for name, a, b in zip(chained._fields, observed, chained):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    _assert_identical((seen[-1], ()), (got[0], ()))
