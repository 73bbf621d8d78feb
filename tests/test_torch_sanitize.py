"""The port's sanitizer mode (`SPT_SANITIZE=1`,
`scheduler_plugins_tpu_torch.utils.sanitize`) on the CPU.

- `tests/test_pipeline.py` TestSanitizeMode re-stated for the port: a
  clean chunk reports ok and keeps its carry readable, an out-of-range
  commit index is caught and reported `out-of-bounds`, a cycle does not
  adopt reports of calls outside it, and the report fields default to
  `[]` / None; plus the same drain in `PipelinedCycle` and `LanedCycle`.
- Every wrap point reports one checked call and gives the outputs of the
  same call without the sanitizer: `profile_batch_solve`,
  `packing_profile_solve`, the streamed cycle's chunks, the served apply
  and `sharded_wave_solve`.
- Every choke point catches its fault and routes the bad row to a zero
  update: `add_rows`, `_scatter_add_rows`, the served delta apply, the
  side-table apply, the node compaction, the fused election's proposals
  and winners, NaN in a float score row, a zero `go_div` divisor.
- With the sanitizer off, the choke points add no ATen operation.
- Against the JAX package, with `SPT_SANITIZE=1` set for both: cycle
  scripts of `tests/test_torch_cycle.py` run sequentially and streamed,
  and seeded served event streams of `tests/test_torch_serving.py`; every
  cycle's `sanitize_checked` and `sanitize_errors` equal JAX's checkify
  counts on the same inputs (with the rest of the report and the store)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
from scheduler_plugins_tpu_torch.api.objects import Container, Pod
from scheduler_plugins_tpu_torch.api.config import load_profile
from scheduler_plugins_tpu_torch.framework import (
    LanedCycle,
    PipelinedCycle,
    Scheduler,
)
from scheduler_plugins_tpu_torch.framework.cycle import CycleReport
from scheduler_plugins_tpu_torch.models import (
    allocatable_scenario,
    gang_quota_scenario,
    numa_scenario,
    packing_scenario,
)
from scheduler_plugins_tpu_torch.ops import assign as assign_ops
from scheduler_plugins_tpu_torch.ops.selectors import _scatter_add_rows
from scheduler_plugins_tpu_torch.parallel.pipeline import run_chunk_pipeline
from scheduler_plugins_tpu_torch.parallel.solver import (
    batch_solve,
    packing_profile_solve,
    profile_batch_solve,
    sharded_wave_solve,
)
from scheduler_plugins_tpu_torch.serving import (
    ServeEngine,
    StreamingServeEngine,
)
from scheduler_plugins_tpu_torch.serving import deltas as D
from scheduler_plugins_tpu_torch.utils import sanitize
from scheduler_plugins_tpu_torch.utils.intmath import add_rows, go_div
from test_torch_cycle import SCRIPTS, run_script
from test_torch_serving import JAX as SERVE_JAX
from test_torch_serving import PORT as SERVE_PORT
from test_torch_serving import randomized_sequence
from test_torch_stream_cycle import run_streamed

try:
    from scheduler_plugins_tpu.utils import sanitize as jax_sanitize
except ImportError:
    jax_sanitize = None

CPU = "cpu"


@pytest.fixture
def sanitized(monkeypatch):
    monkeypatch.setenv("SPT_SANITIZE", "1")
    sanitize.drain()
    yield
    sanitize.drain()


def _single_oob(reports, program):
    assert len(reports) == 1, reports
    assert reports[0]["sanitize"] == program and not reports[0]["ok"]
    assert "out-of-bounds" in reports[0]["error"]


class TestSanitizeMode:
    """`tests/test_pipeline.py` TestSanitizeMode, for the port."""

    def test_clean_chunk_reports_ok(self, sanitized):
        def solve_chunk(x, carry):
            return carry + x, carry - x

        carry0 = torch.ones(4)
        results, carry, _, _ = run_chunk_pipeline(
            solve_chunk, (), [(np.ones(4, np.float32),)], carry0,
            device=CPU)
        np.testing.assert_array_equal(results[0], 2.0)
        # no donation to undo: the carry argument stays readable
        np.testing.assert_array_equal(carry0.numpy(), 1.0)
        reports = sanitize.drain()
        assert reports == [{"sanitize": "chunk:solve_chunk", "ok": True}]

    def test_oob_commit_is_caught(self, sanitized):
        def bad_solve(idx, carry):
            # idx may exceed the carry's rows
            return carry, add_rows(carry, idx, torch.ones(1, 2,
                                                          dtype=torch.int64))

        carry0 = torch.zeros(4, 2, dtype=torch.int64)
        _, carry, _, _ = run_chunk_pipeline(
            bad_solve, (), [(np.array([7]),)], carry0, device=CPU)
        _single_oob(sanitize.drain(), "chunk:bad_solve")
        assert int(carry.sum()) == 0  # the bad row added nothing

    def test_cycle_does_not_adopt_foreign_sanitize_reports(self, sanitized):
        sanitize._REPORTS.append(
            {"sanitize": "foreign", "ok": False, "error": "stale OOB"})
        cluster = allocatable_scenario(4, 8)
        report = port_cycle.run_cycle(chip_smoke.flagship_scheduler(),
                                      cluster, now=0, stream_chunk=8,
                                      device=CPU)
        assert report.sanitize_errors == []
        assert report.sanitize_checked == 1  # the one chunk

    def test_cycle_report_surfaces_sanitize_errors_field(self):
        report = CycleReport()
        assert report.sanitize_errors == []
        # None, not 0: "no errors" must stay distinguishable from "no
        # checked call ran" while the mode is off
        assert report.sanitize_checked is None

    def test_off_fills_nothing(self, monkeypatch):
        monkeypatch.delenv("SPT_SANITIZE", raising=False)
        report = port_cycle.run_cycle(chip_smoke.flagship_scheduler(),
                                      allocatable_scenario(4, 8), now=0,
                                      stream_chunk=8, device=CPU)
        assert report.sanitize_checked is None
        assert sanitize.drain() == []


def _foreign():
    sanitize._REPORTS.append(
        {"sanitize": "foreign", "ok": False, "error": "stale OOB"})


@pytest.mark.parametrize("engine", ["pipelined", "laned"])
def test_engines_drain_foreign_reports(engine, sanitized):
    """`PipelinedCycle` and `LanedCycle` drop reports of calls outside the
    cycle before the snapshot and count the cycle's own after the solve
    (the served apply is checked)."""
    cluster = allocatable_scenario(8, 24)
    sched = chip_smoke.flagship_scheduler()
    if engine == "pipelined":
        eng = PipelinedCycle(sched, cluster,
                             serve=StreamingServeEngine().attach(cluster),
                             device=CPU)
    else:
        eng = LanedCycle(sched, cluster, k=2,
                         serve=ServeEngine().attach(cluster), device=CPU)
    try:
        reports = []
        for now in (1000, 2000):
            _foreign()
            reports.append(eng.tick(now))
            for j in range(4):
                cluster.add_pod(Pod(
                    name=f"late-{now}-{j}", creation_ms=now + j,
                    containers=[Container(requests={"cpu": 500})]))
    finally:
        eng.close()
    # the first cycle rebases and solves sequentially: no checked call;
    # the second applies its deltas through the checked apply
    assert [r.sanitize_checked for r in reports] == [0, 1]
    assert all(r.sanitize_errors == [] for r in reports)


# --- the wrap points: checked, and equal to the unchecked call -------------

def _both(monkeypatch, fn):
    """(fn() with the sanitizer off, fn() with it on, the on run's
    reports)."""
    monkeypatch.delenv("SPT_SANITIZE", raising=False)
    off = fn()
    monkeypatch.setenv("SPT_SANITIZE", "1")
    sanitize.drain()
    on = fn()
    reports = sanitize.drain()
    monkeypatch.delenv("SPT_SANITIZE", raising=False)
    return off, on, reports


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _prepared(cluster, sched):
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=CPU)
    sched.prepare(meta, cluster)
    return snap, meta


@pytest.mark.parametrize("case", ["fast", "gang_quota", "numa"])
def test_profile_batch_solve_checked_and_equal(case, monkeypatch):
    if case == "numa":
        cluster = numa_scenario(32, 48, zones=4)
        sched = Scheduler(load_profile(
            {"plugins": ["NodeResourceTopologyMatch"]}))
    else:
        cluster = (allocatable_scenario(16, 64) if case == "fast"
                   else gang_quota_scenario(4, 8, 16))
        sched = chip_smoke.flagship_scheduler()
    snap, _ = _prepared(cluster, sched)
    off, on, reports = _both(monkeypatch, lambda: profile_batch_solve(
        sched, snap, collect_stats=True, device=CPU))
    assert _equal(off, on)
    assert reports == [{"sanitize": "profile_batch", "ok": True}]


def test_packing_profile_solve_checked_and_equal(monkeypatch):
    cluster, snap, meta, _ = packing_scenario(24, 0.85, 0.15, device=CPU)
    sched = Scheduler(load_profile({
        "plugins": ["NodeResourcesAllocatable"], "solveMode": "packing",
        "packingConfig": {"iterations": 8}}))
    sched.prepare(meta, cluster)

    def solve():
        view = packing_profile_solve(sched, snap, device=CPU)
        return view.assignment, view.admitted, view.wait, view.stats

    off, on, reports = _both(monkeypatch, solve)
    assert _equal(off, on)
    assert reports == [{"sanitize": "profile_packing", "ok": True}]


def test_sharded_wave_solve_checked_and_equal(monkeypatch):
    """The blocked solve under the sanitizer keeps its kernels' wrappers,
    called as often as unchecked (their plain versions on the CPU; the
    JAX package drops Pallas there instead), and equals both the
    unchecked call and `batch_solve`."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    calls = []
    for name in ("block_offsets", "elect_min", "fused_election"):
        def counted(*args, _fn=getattr(pk, name), _name=name):
            calls.append(_name)
            return _fn(*args)
        monkeypatch.setattr(pk, name, counted)
    cluster = allocatable_scenario(40, 600)
    snap, meta = cluster.snapshot(
        sorted(cluster.pending_pods(), key=lambda p: p.creation_ms),
        device=CPU)
    weights = meta.index.encode({"cpu": 1 << 20, "memory": 1})

    def solve():
        calls.clear()
        out = sharded_wave_solve(snap, weights, 4, chunk=256,
                                 rescue_window=64)
        return out, sorted(calls)

    (off, off_calls), (on, on_calls), reports = _both(monkeypatch, solve)
    assert off_calls == on_calls and set(on_calls) == {
        "block_offsets", "elect_min", "fused_election"}
    assert _equal(off, on)
    assert _equal(on, batch_solve(snap, weights, chunk=256,
                                  rescue_window=64))
    assert reports == [{"sanitize": "sharded_wave_solve", "ok": True}]


def test_streamed_and_served_cycles_checked_and_equal(monkeypatch):
    def cycles(serve):
        cluster = allocatable_scenario(16, 64)
        sched = chip_smoke.flagship_scheduler()
        engine = ServeEngine().attach(cluster) if serve else None
        out = []
        for now in (1000, 2000):
            r = port_cycle.run_cycle(sched, cluster, now=now,
                                     stream_chunk=None if serve else 16,
                                     serve=engine, device=CPU)
            out.append((r.bound, r.failed, r.sanitize_checked,
                        r.sanitize_errors))
            for j in range(4):
                cluster.add_pod(Pod(
                    name=f"late-{now}-{j}", creation_ms=now + j,
                    containers=[Container(requests={"cpu": 500})]))
        return out

    for serve in (False, True):
        off, on, _ = _both(monkeypatch, lambda: cycles(serve))
        assert [o[:2] for o in off] == [o[:2] for o in on]
        assert all(o[2] is None for o in off)
        assert all(o[3] == [] for o in on)
        # streamed: one checked call a chunk (64 pods in 4 chunks, then
        # 4 pods in one); served: the first cycle rebases (no checked
        # call), the second applies its deltas
        assert [o[2] for o in on] == ([0, 1] if serve else [4, 1])


# --- the choke points --------------------------------------------------------

def _checked(fn):
    """fn() inside one checked call; (result, that call's report)."""
    with sanitize.checked("planted"):
        out = fn()
    reports = sanitize.drain()
    assert len(reports) == 1
    return out, reports[0]


def test_add_rows_oob(sanitized):
    target = torch.zeros(4, 2, dtype=torch.int64)
    out, rep = _checked(lambda: add_rows(
        target, torch.tensor([1, 9, -1]), torch.ones(3, 2,
                                                     dtype=torch.int64)))
    assert not rep["ok"] and rep["error"] == "out-of-bounds index in add_rows"
    assert out.tolist() == [[0, 0], [1, 1], [0, 0], [0, 0]]
    out, rep = _checked(lambda: add_rows(
        torch.zeros(4, dtype=torch.int64), torch.tensor([3, 0]),
        torch.tensor([2, 5])))
    assert rep == {"sanitize": "planted", "ok": True}
    assert out.tolist() == [5, 0, 0, 2]


def test_scatter_add_rows_oob(sanitized):
    carry = torch.zeros(2, 3, dtype=torch.int64)
    out, rep = _checked(lambda: _scatter_add_rows(
        carry, torch.tensor([[1], [5]]), torch.tensor([[2], [3]])))
    assert not rep["ok"] and "_scatter_add_rows" in rep["error"]
    assert out.tolist() == [[0, 2, 0], [0, 0, 0]]
    # -1 is "no domain" (adds nothing), not a fault
    out, rep = _checked(lambda: _scatter_add_rows(
        carry, torch.tensor([[-1], [2]]), torch.tensor([[0], [3]])))
    assert rep["ok"] and out.tolist() == [[0, 0, 0], [0, 0, 3]]


def _node_batch(n, slots_up, slots_use):
    R = len(D.CANON_INDEX)
    ups = D.NodeUpserts.pack([(s, np.full(R, 7), np.full(R, 7), True, -1, -1)
                              for s in slots_up], R)
    use = D.UsageDeltas.pack([(s, np.ones(R, np.int64), np.ones(R, np.int64),
                               np.ones(R, np.int64), 1, 0)
                              for s in slots_use], R)
    return D.stage(ups.as_args() + use.as_args(), torch.device(CPU))


def _resident(n):
    cluster = allocatable_scenario(n, 1)
    snap, _ = cluster.snapshot([], now_ms=0, device=CPU)
    return snap.nodes


def test_delta_apply_oob(sanitized):
    nodes = _resident(8)
    before = {k: getattr(nodes, k).clone() for k in ("alloc", "requested")}
    out = D.apply_node_deltas(nodes, *_node_batch(8, [2, 99], [3, 99]))
    reports = sanitize.drain()
    assert len(reports) == 1 and reports[0]["sanitize"] == "serve_delta_apply"
    assert "out-of-bounds index in apply_node_deltas upserts" in \
        reports[0]["error"]
    assert "out-of-bounds index in apply_node_deltas usage" in \
        reports[0]["error"]
    # the good rows landed, the bad ones added nothing anywhere else
    assert (out.alloc[2] == 7).all()
    assert (out.requested[3] == before["requested"][3] + 1).all()
    changed = (out.requested != before["requested"]).any(dim=1)
    assert changed.nonzero().flatten().tolist() == [3]


def test_delta_apply_clean_equals_unchecked(monkeypatch):
    def apply():
        return D.apply_node_deltas(_resident(8), *_node_batch(8, [1, 5],
                                                              [0, 5, 5]))
    off, on, reports = _both(monkeypatch, apply)
    for k in ("alloc", "capacity", "requested", "nonzero_requested",
              "limits", "mask", "region", "zone", "pod_count", "terminating",
              "nominated"):
        assert torch.equal(getattr(off, k), getattr(on, k)), k
    assert reports == [{"sanitize": "serve_delta_apply", "ok": True}]


def test_side_apply_oob(sanitized):
    R = len(D.CANON_INDEX)
    tables = D.zero_side_tables(2, 2, R, torch.device(CPU))
    packed = D.SideDeltas.pack([(1, 1, 0, np.ones(R, np.int64)),
                                (9, 1, 0, np.ones(R, np.int64))],
                               [(0, np.ones(R, np.int64), 1),
                                (5, np.ones(R, np.int64), 1)], R)
    out = D.apply_side_deltas(tables, *D.stage(packed.as_args(),
                                               torch.device(CPU)))
    reports = sanitize.drain()
    assert reports[0]["sanitize"] == "serve_side_apply"
    assert "gangs" in reports[0]["error"] and "quotas" in reports[0]["error"]
    assert out.gang_assigned.tolist() == [0, 1]
    assert out.ns_assigned.tolist() == [1, 0]


def test_compaction_oob(sanitized):
    nodes = _resident(8)
    npad = nodes.alloc.shape[0]
    idx = np.arange(npad)
    idx[0] = npad + 3
    valid = np.ones(npad, bool)
    out = D.compact_node_rows(nodes, *D.stage((idx, valid),
                                              torch.device(CPU)))
    _single_oob(sanitize.drain(), "serve_node_compact")
    assert not bool(out.mask[0]) and int(out.alloc[0].sum()) == 0
    assert torch.equal(out.alloc[1:], nodes.alloc[1:])


def test_fused_election_checks(sanitized):
    """A proposal past the sentinel is reported and sent to the sentinel
    before the launch; a winner id past the real nodes is reported."""
    from scheduler_plugins_tpu_torch.parallel import kernels as pk

    S, BS, R = 2, 3, 2
    node_ids = torch.arange(S * BS, dtype=torch.int32).view(S, BS)
    rank_free = torch.ones(S, BS, R, dtype=torch.int64)
    prop = torch.tensor([[0, 6, 99], [6, 4, 6]], dtype=torch.int64)

    def elect(n_real):
        with sanitize.checked("planted") as check:
            guarded = assign_ops._guard_proposals(check, prop, S * BS)
            out = pk.fused_election(guarded, node_ids, rank_free)
            assign_ops._check_winners(check, out[1], n_real)
        reports = sanitize.drain()
        assert len(reports) == 1
        return out, reports[0]

    (rank, node_plus, _), rep = elect(6)
    assert rep["error"] == ("out-of-bounds index in fused_election "
                            "proposals")
    assert rank.tolist() == [0, 4, 6] and node_plus.tolist() == [1, 5, 0]
    _, rep = elect(3)
    assert "out-of-bounds index in fused_election winners" in rep["error"]


def test_nan_keys_and_scores(sanitized):
    _, rep = _checked(lambda: sanitize.current().nan(
        torch.tensor([[1.0, float("nan")]], dtype=torch.float64),
        "block_offsets keys"))
    assert rep["error"] == "NaN in block_offsets keys"
    _, rep = _checked(lambda: sanitize.current().nan(
        torch.tensor([[1, 2]]), "integer keys"))
    assert rep["ok"]

    from scheduler_plugins_tpu_torch.framework.runtime import Profile
    from scheduler_plugins_tpu_torch.plugins.noderesources import (
        NodeResourcesAllocatable,
    )

    class _NanAllocatable(NodeResourcesAllocatable):
        name = "NanAllocatable"

        def filter(self, state, snap, p):
            # a Filter keeps the profile off the targeted fast path
            return snap.nodes.mask

        def score_batch(self, state, snap):
            out = self.score(state, snap, 0).to(torch.float64)
            out = out.expand(snap.num_pods, -1).clone()
            out[0, 0] = float("nan")
            return out

    sched = Scheduler(Profile(plugins=[_NanAllocatable()]))
    snap, _ = _prepared(allocatable_scenario(8, 8), sched)
    profile_batch_solve(sched, snap, device=CPU)
    reports = sanitize.drain()
    assert len(reports) == 1 and not reports[0]["ok"]
    assert reports[0]["error"] == "NaN in NanAllocatable score rows"


def test_go_div_zero_divisor(sanitized):
    out, rep = _checked(lambda: go_div(torch.tensor([6, -7]),
                                       torch.tensor([3, 0])))
    assert rep["error"] == "division by zero in go_div"
    # the zero divisor is replaced by 1, so the call finishes
    assert out.tolist() == [2, -7]
    out, rep = _checked(lambda: go_div(torch.tensor([6, -7]), 2))
    assert rep["ok"] and out.tolist() == [3, -3]


def test_nested_calls_join_the_outer(sanitized):
    with sanitize.checked("outer") as outer:
        with sanitize.checked("inner") as inner:
            add_rows(torch.zeros(2, dtype=torch.int64), torch.tensor([5]),
                     torch.tensor([1]))
        assert inner is outer
    _single_oob(sanitize.drain(), "outer")


def test_raise_records_no_report(sanitized):
    with pytest.raises(ValueError):
        with sanitize.checked("boom"):
            raise ValueError("x")
    assert sanitize.drain() == [] and sanitize.current() is None


# --- off: no operation added ---------------------------------------------------

class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["unset", "on_outside_a_call"])
def test_choke_points_add_no_op_outside_a_checked_call(mode, monkeypatch):
    """Outside a checked call (the mode off, or on but no wrap point open,
    as in the sequential solve) a choke point dispatches exactly the
    operation it always did."""
    if mode == "unset":
        monkeypatch.delenv("SPT_SANITIZE", raising=False)
    else:
        monkeypatch.setenv("SPT_SANITIZE", "1")
    args = [
        (torch.zeros(4, 2, dtype=torch.int64), torch.tensor([1]),
         torch.ones(1, 2, dtype=torch.int64)),
        (torch.zeros(4, 3, dtype=torch.int64),
         torch.tensor([[1], [0], [2], [1]]),
         torch.ones(4, 1, dtype=torch.int64)),
        (torch.tensor([4]), torch.tensor([2])),
    ]
    with _Ops() as log:
        add_rows(*args[0])
        _scatter_add_rows(*args[1])
        go_div(*args[2])
    # the parent commit's operations, before the sanitizer existed
    assert log.ops == ["unsqueeze.default", "expand.default",
                       "scatter_add.default", "clamp.default",
                       "scatter_add.default", "div.Tensor_mode"]
    assert sanitize.drain() == []


# --- against the JAX package, the sanitizer on for both -------------------

@pytest.fixture
def both_sanitized(monkeypatch):
    """`SPT_SANITIZE=1` for both packages, their report buffers empty
    before and after."""
    if jax_sanitize is None:
        pytest.skip("the JAX package is not importable here")
    monkeypatch.setenv("SPT_SANITIZE", "1")
    sanitize.drain()
    jax_sanitize.drain()
    yield
    sanitize.drain()
    jax_sanitize.drain()


#: cycle scripts run under the sanitizer: plain binds, a gang quorum, the
#: capacity quota, a preemption and a churn stream
SANITIZED_SCRIPTS = [
    s for s in SCRIPTS if s.__name__ in {
        "smoke_script", "gang_quorum_completes", "quota_borrowing_admits",
        "preempt_lower_priority", "churn_seed0",
    }
]


@pytest.mark.parametrize("script", SANITIZED_SCRIPTS,
                         ids=lambda s: s.__name__)
def test_sequential_scripts_sanitized_match_jax(both_sanitized, script,
                                                monkeypatch):
    """The sequential solve is no checked program in either package:
    `sanitize_checked` is 0 on a cycle that solved and None on one that
    ended before the solve, as JAX's (compared by `report_diff` with the
    rest of the report)."""
    _, reports = run_script(script, monkeypatch)
    assert {r.sanitize_checked for r in reports} <= {0, None}
    assert any(r.sanitize_checked == 0 for r in reports)


@pytest.mark.parametrize(
    "script", [s for s in SANITIZED_SCRIPTS
               if s.__name__ in {"smoke_script", "gang_quorum_completes",
                                 "churn_seed0"}],
    ids=lambda s: s.__name__)
def test_streamed_scripts_sanitized_match_jax(both_sanitized, script,
                                              monkeypatch):
    """One checked call a streamed chunk in both packages: the counts and
    the (empty) findings equal JAX's checkify reports cycle by cycle."""
    reports = run_streamed(script, monkeypatch)
    assert any(r.sanitize_checked for r in reports)
    assert all(r.sanitize_errors == [] for r in reports)


def _sanitize_fields(pkg, seen):
    """`pkg` whose `run` also records (served, sanitize_checked,
    sanitize_errors) of every cycle."""
    def run(s, c, now, e=None):
        report = pkg.run(s, c, now, e)
        seen.append((e is not None, report.sanitize_checked,
                     report.sanitize_errors))
        return report

    return SimpleNamespace(**{**vars(pkg), "run": run})


@pytest.mark.parametrize("seed", [0, 1])
def test_served_streams_sanitized_match_jax(both_sanitized, seed):
    """`tests/test_torch_serving.py`'s seeded event streams (arrivals,
    departures, terminations, node adds and updates) with the served
    apply checked in both packages: every served and full-snapshot
    cycle's sanitizer fields equal JAX's, and so does the rest of the
    scenario's record."""
    seen_port, seen_jax = [], []
    port = randomized_sequence(_sanitize_fields(SERVE_PORT, seen_port),
                               seed)
    jax = randomized_sequence(_sanitize_fields(SERVE_JAX, seen_jax), seed)
    assert port == jax
    assert seen_port == seen_jax
    assert any(checked for served, checked, _ in seen_port if served)
