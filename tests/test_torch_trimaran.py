"""The port's Trimaran slice (`scheduler_plugins_tpu_torch.ops.trimaran`,
`.plugins.trimaran`, the metrics table of the snapshot, the store's
missing-CPU compensation and the cycle's collector hooks) against the JAX
package.

Ops: seeded numpy metrics, with nodes that report nothing, only a CPU std
sample, only memory, and nodes of zero capacity, go through each JAX
curve and its port:

- TLP and LVRB, per pod and in batch, and LROC: tolerance 0 on the int64
  (int32 in batch) scores. Every float step is a correctly rounded
  IEEE-754 operation (+, -, *, /, sqrt) written in JAX's order, and the
  batch's float32 stage matches too (XLA on the CPU contracts nothing into
  an FMA there), so nothing is left to round differently. LROC's beta CDF
  carries `lgamma`/`log`/`exp` differences of ~1e-12 (below), which the
  round to an integer score absorbs on these inputs.
- `betainc` against `jax.scipy.special.betainc` on a seeded (a, b, x)
  grid: relative 1e-10, absolute 1e-12. The continued fraction is the same
  sequence of correctly rounded operations; the prefactor's `lgamma`,
  `log`, `log1p` and `exp` come from another libm than XLA's, each within
  an ulp or two of the exact value, and exp(a log x + b log1p(-x) -
  log B) turns an ulp of its argument (|arg| up to ~1e4 for a, b up to
  1000) into ~1e-12 relative.
- Peaks raw scores: |port - JAX| <= 2^-50 * 1e15 * K1 * (e^(K2 p) +
  e^(K2 x)) + 2. The two `exp`s may each be an ulp off XLA's (2^-52
  relative; the bound allows 4), the jump is their difference scaled by
  1e15 and truncated (the +2). The normalized scores and the placements
  are held exactly.
- the normalizers: tolerance 0.

The reference decision tables of `tests/test_trimaran.py` and
`tests/test_lroc_beta_tables.py` run again with the JAX functions they
call replaced by the port's.

The parity path: the sequential solve uses neither chunking nor a float32
stage, so `Scheduler.solve` is held bit for bit (assignment, admitted,
wait, failed_plugin and the final carry) on a reduced bench config 2
(`trimaran_scenario(256, 512)`, TLP + LVRB) and on each
`torch_trimaran_cases` problem; `run_cycle` cycle by cycle over a script
that exercises the missing-CPU compensation and the binding-cache GC; and
the explain rows, sequential and batched, equal JAX's.

The `cuda`-marked test runs on a card only (`python -m pytest
tests/test_torch_trimaran.py -m cuda`); it needs no JAX."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.ops.trimaran as t_tri
from scheduler_plugins_tpu_torch.api import config as port_config
from scheduler_plugins_tpu_torch.convert import (
    snapshot_from_numpy,
    state_from_numpy,
)
from scheduler_plugins_tpu_torch.framework import Scheduler
from scheduler_plugins_tpu_torch.ops import normalize as t_norm
from scheduler_plugins_tpu_torch.parallel.solver import batch_explain_rows
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from scheduler_plugins_tpu_torch.state.snapshot import MetricsState
from torch_parity_cases import parity_outputs
from torch_trimaran_cases import CASES, solve_inputs, trimaran_case

try:
    import jax.numpy as jnp
    from jax.scipy.special import betainc as jax_betainc

    import scheduler_plugins_tpu.api.config as jax_config
    import scheduler_plugins_tpu.api.objects as jax_objects
    import scheduler_plugins_tpu.framework.cycle as jax_cycle
    import scheduler_plugins_tpu.ops.normalize as j_norm
    import scheduler_plugins_tpu.ops.trimaran as j_tri
    import scheduler_plugins_tpu.utils.intmath as j_intmath
    import tests.test_lroc_beta_tables as jax_lroc_tables
    import tests.test_trimaran as jax_tables
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.parallel.solver import (
        batch_explain_rows as jax_batch_explain_rows,
    )
    from scheduler_plugins_tpu.state.cluster import Cluster as JCluster
    from scheduler_plugins_tpu.state.snapshot import (
        MetricsState as JMetricsState,
    )
    from tests.test_torch_cycle import (
        JAX as JAX_CYCLE,
        PORT as PORT_CYCLE,
        report_diff,
        store_diff,
    )
    from tests.test_torch_parity_solve import (
        MASKS,
        assert_result_equal,
        jax_snapshot_tree,
        numpy_tree,
        score_rows,
    )
    from tests.test_torch_snapshot import JAX, PORT
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None
    MASKS = {}

GIB = 1 << 30
CPU = torch.device("cpu")
CONFIG2 = {"plugins": ["TargetLoadPacking", "LoadVariationRiskBalancing"]}


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


def t(x):
    return torch.as_tensor(np.ascontiguousarray(np.asarray(x)))


def j(x):
    return jnp.asarray(np.asarray(x))


# --- seeded metrics ---------------------------------------------------------

def seeded_nodes(seed: int, n: int = 96) -> dict:
    """Per-node inputs of the curves: metric columns over and under their
    range, nodes that report nothing (kind 1), only a CPU std (2), only
    memory (3) or only CPU (4); every seventh node has no CPU capacity and
    every eleventh no memory."""
    rng = np.random.default_rng(seed)
    kind = np.arange(n) % 6
    m = {
        "cpu_avg": rng.uniform(-5, 110, n), "cpu_std": rng.uniform(-2, 40, n),
        "mem_avg": rng.uniform(-5, 110, n), "mem_std": rng.uniform(0, 40, n),
    }
    m["cpu_avg"][(kind == 1) | (kind == 2) | (kind == 3)] = 0.0
    m["mem_avg"][(kind == 1) | (kind == 4)] = 0.0
    m["cpu_tlp"] = m["cpu_avg"].copy()
    m["cpu_peaks"] = m["cpu_avg"].copy()
    m["cpu_valid"] = ~np.isin(kind, (1, 3))
    m["cpu_tlp_valid"] = ~np.isin(kind, (1, 2, 3))
    m["mem_valid"] = ~np.isin(kind, (1, 2, 4))
    m["missing_cpu_millis"] = rng.integers(0, 3000, n) * (kind % 2)
    cap_cpu = rng.integers(1000, 64_000, n)
    cap_cpu[::7] = 0
    cap_mem = rng.integers(1, 64, n) * GIB
    cap_mem[::11] = 0
    return {"metrics": m, "cap_cpu": cap_cpu, "cap_mem": cap_mem,
            "req_cpu": rng.integers(0, 60_000, n),
            "req_mem": rng.integers(0, 60, n) * GIB,
            "lim_extra_cpu": rng.integers(0, 40_000, n),
            "lim_extra_mem": rng.integers(0, 40, n) * GIB,
            "k1": rng.uniform(0, 8, n) * (np.arange(n) % 4 != 3),
            "k2": rng.uniform(0, 0.2, n)}


def metrics_pair(m):
    return (JMetricsState(**{k: j(v) for k, v in m.items()}),
            MetricsState(**{k: t(v) for k, v in m.items()}))


def seeded_pods(seed: int, n: int = 40):
    rng = np.random.default_rng(seed + 1)
    pods = {"predicted": rng.integers(0, 9000, n),
            "cpu": rng.integers(0, 9000, n),
            "mem": rng.integers(0, 8 * GIB, n)}
    pods["cpu"][::5] = 0
    pods["mem"][::4] = 0
    return pods


def assert_same(port_value, jax_value, msg=""):
    got = port_value.cpu().numpy()
    want = np.asarray(jax_value)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


# --- the curves -------------------------------------------------------------

class TestTLP:
    @pytest.mark.parametrize("target", [40.0, 60.0, 17.0, 100.0])
    def test_per_pod_equals_jax(self, target):
        nodes, pods = seeded_nodes(0), seeded_pods(0)
        m = nodes["metrics"]
        for p, pred in enumerate(pods["predicted"]):
            want = j_tri.tlp_score(
                j(m["cpu_tlp"]), j(m["cpu_tlp_valid"]),
                j(m["missing_cpu_millis"]), j(nodes["cap_cpu"]),
                jnp.int64(pred), target)
            got = t_tri.tlp_score(
                t(m["cpu_tlp"]), t(m["cpu_tlp_valid"]),
                t(m["missing_cpu_millis"]), t(nodes["cap_cpu"]),
                t(pods["predicted"][p:p + 1]), target)
            assert_same(got, want, f"pod {p}")

    @pytest.mark.parametrize("target", [40.0, 60.0, 17.0])
    def test_batch_equals_jax_and_per_pod_within_one(self, target):
        nodes, pods = seeded_nodes(1), seeded_pods(1, n=300)
        m = nodes["metrics"]
        args = ("cpu_tlp", "cpu_tlp_valid", "missing_cpu_millis")
        want = j_tri.tlp_score_batch(
            *[j(m[k]) for k in args], j(nodes["cap_cpu"]),
            j(pods["predicted"]), target)
        got = t_tri.tlp_score_batch(
            *[t(m[k]) for k in args], t(nodes["cap_cpu"]),
            t(pods["predicted"]), target)
        assert_same(got, want)
        per_pod = torch.stack([t_tri.tlp_score(
            *[t(m[k]) for k in args], t(nodes["cap_cpu"]),
            t(pods["predicted"][p:p + 1]), target)
            for p in range(300)])
        assert (per_pod - got).abs().max() <= 1


LVRB_ARGS = [(1.0, 1.0), (2.0, 2.0), (1.0, 0.5), (0.5, 3.0), (1.0, 0.0),
             (1.0, -1.0), (1.5, 0.7)]


class TestLVRB:
    @pytest.mark.parametrize("margin,sensitivity", LVRB_ARGS)
    def test_per_pod_equals_jax(self, margin, sensitivity):
        nodes, pods = seeded_nodes(2), seeded_pods(2)
        jm, tm = metrics_pair(nodes["metrics"])
        for p in range(len(pods["cpu"])):
            want = j_tri.lvrb_score(
                jm, j(nodes["cap_cpu"]), j(nodes["cap_mem"]),
                jnp.int64(pods["cpu"][p]), jnp.int64(pods["mem"][p]),
                margin, sensitivity)
            got = t_tri.lvrb_score(
                tm, t(nodes["cap_cpu"]), t(nodes["cap_mem"]),
                t(pods["cpu"][p:p + 1]), t(pods["mem"][p:p + 1]), margin,
                sensitivity)
            assert_same(got, want, f"pod {p}")

    @pytest.mark.parametrize("margin,sensitivity", LVRB_ARGS)
    def test_batch_equals_jax(self, margin, sensitivity):
        nodes, pods = seeded_nodes(3), seeded_pods(3, n=300)
        jm, tm = metrics_pair(nodes["metrics"])
        want = j_tri.lvrb_score_batch(
            jm, j(nodes["cap_cpu"]), j(nodes["cap_mem"]), j(pods["cpu"]),
            j(pods["mem"]), margin, sensitivity)
        got = t_tri.lvrb_score_batch(
            tm, t(nodes["cap_cpu"]), t(nodes["cap_mem"]), t(pods["cpu"]),
            t(pods["mem"]), margin, sensitivity)
        assert_same(got, want)


class TestLROC:
    @pytest.mark.parametrize("window,w_cpu,w_mem", [(5, 0.5, 0.5),
                                                    (3, 0.3, 0.7),
                                                    (1, 1.0, 0.0)])
    def test_per_pod_equals_jax(self, window, w_cpu, w_mem):
        nodes, pods = seeded_nodes(4, n=64), seeded_pods(4, n=12)
        jm, tm = metrics_pair(nodes["metrics"])
        node_cols = (nodes["cap_cpu"], nodes["cap_mem"], nodes["req_cpu"],
                     nodes["req_mem"],
                     nodes["req_cpu"] + nodes["lim_extra_cpu"],
                     nodes["req_mem"] + nodes["lim_extra_mem"])
        for p in range(len(pods["cpu"])):
            pod = (pods["cpu"][p], pods["mem"][p],
                   2 * pods["cpu"][p] if p % 2 else 0,
                   pods["mem"][p] if p % 3 else 0)
            want = j_tri.lroc_score(jm, *[j(c) for c in node_cols],
                                    *[jnp.int64(v) for v in pod], window,
                                    w_cpu, w_mem)
            got = t_tri.lroc_score(tm, *[t(c) for c in node_cols],
                                   *[torch.tensor([v]) for v in pod], window,
                                   w_cpu, w_mem)
            assert_same(got, want, f"pod {p}")

    def test_risk_and_probability_close_to_jax(self):
        """The floats under the integer score: within the betainc
        tolerance (module docstring)."""
        rng = np.random.default_rng(5)
        mu, sigma = rng.uniform(0, 1, 300), rng.uniform(0, 0.4, 300)
        thr = rng.uniform(0, 1, 300)
        mu[:10], sigma[10:20] = 0.0, 0.0
        want = j_tri.compute_probability(j(mu), j(sigma), j(thr))
        got = t_tri.compute_probability(t(mu), t(sigma), t(thr))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for g, w in zip((got[0], got[2], got[3]), (want[0], want[2],
                                                   want[3])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                       atol=1e-12)

    def test_stacked_rows_are_separate_calls(self):
        """`betainc` over (K, N) rows equals K calls of one row each: each
        row is its own continued fraction, as each JAX call is."""
        rng = np.random.default_rng(6)
        a = 10 ** rng.uniform(-2, 4, (4, 50))
        b = 10 ** rng.uniform(-2, 4, (4, 50))
        x = rng.uniform(0, 1, (4, 50))
        rows = t_tri.betainc(t(a), t(b), t(x))
        for k in range(4):
            torch.testing.assert_close(
                rows[k], t_tri.betainc(t(a[k]), t(b[k]), t(x[k])),
                rtol=0, atol=0)


class TestBetainc:
    def test_grid_close_to_jax(self):
        rng = np.random.default_rng(20261017)
        n = 3000
        a = 10 ** rng.uniform(-2, 3, n)
        b = 10 ** rng.uniform(-2, 3, n)
        x = rng.uniform(0, 1, n)
        x[:8], x[8:16] = 0.0, 1.0
        a[16:20], b[20:24] = 0.0, 0.0
        x[24] = np.nan
        a[25], x[26] = -1.0, 1.5
        want = np.asarray(jax_betainc(j(a), j(b), j(x)))
        got = t_tri.betainc(t(a), t(b), t(x)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
        # the edge cases are exact
        edge = slice(0, 27)
        np.testing.assert_array_equal(got[edge], want[edge])


class TestPeaks:
    def test_raw_within_the_exp_bound_and_normalized_exact(self):
        nodes, pods = seeded_nodes(7), seeded_pods(7)
        m = nodes["metrics"]
        k1, k2 = nodes["k1"], nodes["k2"]
        cap = nodes["cap_cpu"].astype(float)
        mask = np.random.default_rng(8).random(len(k1)) < 0.8
        for p in range(len(pods["cpu"])):
            want = np.asarray(j_tri.peaks_score(
                j(m["cpu_peaks"]), j(m["cpu_tlp_valid"]),
                j(nodes["cap_cpu"]), jnp.int64(pods["cpu"][p]), j(k1),
                j(k2)))
            got = t_tri.peaks_score(
                t(m["cpu_peaks"]), t(m["cpu_tlp_valid"]),
                t(nodes["cap_cpu"]), t(pods["cpu"][p:p + 1]), t(k1), t(k2))
            assert got.dtype == torch.int64
            pred = np.where(cap != 0, 100.0 * (m["cpu_peaks"] / 100.0 * cap
                                               + pods["cpu"][p])
                            / np.maximum(cap, 1.0), 0.0)
            bound = 2.0 ** -50 * 1e15 * np.abs(k1) * (
                np.exp(k2 * pred) + np.exp(k2 * m["cpu_peaks"])) + 2
            diff = np.abs(got.numpy().astype(float) - want.astype(float))
            assert (diff <= bound).all(), (p, diff.max())
            norm_j = np.asarray(j_norm.peaks_normalize(j(want), j(mask)))
            norm_t = t_norm.peaks_normalize(got, t(mask)).numpy()
            np.testing.assert_array_equal(norm_t, norm_j, err_msg=f"pod {p}")

    def test_overflow_saturates_like_xla(self):
        """A jump past int64 saturates, as XLA's float-to-int conversion
        does (a plain cast would wrap to INT64_MIN)."""
        # predicted 60 %: 8 * e^(0.8 * 60) * 1e15 is far past 2^63
        args = ([50.0, 10.0], [True, True], [1000, 1000], 100, [8.0, 1.0],
                [0.8, 0.01])
        want = np.asarray(j_tri.peaks_score(*[j(a) for a in args[:3]],
                                            jnp.int64(args[3]), j(args[4]),
                                            j(args[5])))
        got = t_tri.peaks_score(*[t(a) for a in args[:3]],
                                torch.tensor([args[3]]), t(args[4]),
                                t(args[5]))
        assert want[0] == np.iinfo(np.int64).max
        assert got[0] == want[0]


class TestNormalize:
    @pytest.mark.parametrize("mask", sorted(MASKS))
    @pytest.mark.parametrize("reverse", [False, True])
    def test_default_normalize(self, mask, reverse):
        rng = np.random.default_rng(9)
        scores = np.abs(score_rows(rng)) % 5000
        m = MASKS[mask](rng, scores.shape)
        assert_same(t_norm.default_normalize(t(scores), t(m), reverse),
                    j_norm.default_normalize(j(scores), j(m), reverse))

    @pytest.mark.parametrize("mask", sorted(MASKS))
    def test_peaks_normalize(self, mask):
        rng = np.random.default_rng(10)
        scores = score_rows(rng)
        scores[3] = 0  # the all-zero row keeps its scores
        m = MASKS[mask](rng, scores.shape)
        assert_same(t_norm.peaks_normalize(t(scores), t(m)),
                    j_norm.peaks_normalize(j(scores), j(m)))


# --- the reference decision tables, against the port ------------------------

def _to_torch(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.array(x))


def _port_call(fn):
    """`fn` of the port, called with the JAX tables' arguments (JAX
    arrays and numbers) as tensors, returning numpy as the tables read
    it."""
    def call(*args, **kwargs):
        out = fn(*[a if isinstance(a, (int, float)) else _to_torch(a)
                   for a in args], **kwargs)
        if isinstance(out, tuple):
            return tuple(o.numpy() for o in out)
        return out.numpy()

    return call


def _methods(cls):
    """(method name, args) per test of a JAX table class, one entry per
    parameter set of a parametrized method."""
    out = []
    for name in sorted(vars(cls)):
        if not name.startswith("test_"):
            continue
        marks = [m for m in getattr(getattr(cls, name), "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, ()))
            continue
        argnames, values = marks[0].args
        names = [a.strip() for a in argnames.split(",")]
        for v in values:
            out.append((name, tuple(v) if len(names) > 1 else (v,)))
    return out


def _tables():
    if JAX is None:
        return []
    classes = [
        jax_tables.TestComputeScoreVectors, jax_tables.TestGetMuSigmaVectors,
        jax_tables.TestTLPReferenceVectors,
        jax_tables.TestComputeScoreReferenceVectors,
        jax_lroc_tables.TestMomentMatchedFit,
        jax_lroc_tables.TestDistributionFunction,
        jax_lroc_tables.TestComputeProbabilityEdges,
        jax_lroc_tables.TestComputeRiskGoldens,
    ]
    return [pytest.param(cls, name, args, id=f"{cls.__name__}.{name}{args}")
            for cls in classes for name, args in _methods(cls)]


@pytest.mark.parametrize("cls,method,args", _tables())
def test_reference_table_against_port(cls, method, args, monkeypatch):
    """Each reference vector of the JAX decision tables, with the JAX
    functions the table calls swapped for the port's."""
    monkeypatch.setattr(jax_tables, "tlp_score", _port_call(t_tri.tlp_score))
    monkeypatch.setattr(j_tri, "_risk_component",
                        _port_call(t_tri._risk_component))
    monkeypatch.setattr(j_intmath, "round_half_away",
                        _port_call(t_tri.round_half_away))
    monkeypatch.setattr(jax_lroc_tables, "compute_probability",
                        _port_call(t_tri.compute_probability))
    monkeypatch.setattr(jax_lroc_tables, "_risk_one_resource",
                        _port_call(t_tri._risk_one_resource))
    getattr(cls(), method)(*args)


# --- the plugins --------------------------------------------------------------

def gate_cluster(pkg, pod):
    """tests/test_lroc_beta_tables.py TestScoreGates' one-node cluster."""
    o = pkg.objects
    c = pkg.Cluster()
    c.add_node(o.Node(name="node-1", allocatable={
        "cpu": 1000, "memory": GIB, "pods": 110}))
    c.node_metrics = {"node-1": {"cpu_avg": 20.0}}
    c.add_pod(pod(o))
    return c


@pytest.mark.parametrize("pod,positive", [
    (lambda o: o.Pod(name="p", containers=[o.Container()]), False),
    (lambda o: o.Pod(name="p", containers=[o.Container(
        requests={"cpu": 100})]), True),
])
def test_lroc_best_effort_gate(pod, positive):
    """A best-effort pod scores the minimum, a requesting pod more
    (lowriskovercommitment.go:122-137), as in JAX."""
    raws = []
    for pkg, load, kw in ((JAX, jax_config.load_profile, {}),
                          (PORT, port_config.load_profile,
                           {"device": "cpu"})):
        cluster = gate_cluster(pkg, pod)
        sched = (JScheduler if pkg is JAX else Scheduler)(
            load({"plugins": ["LowRiskOverCommitment"]}))
        _, snap, _ = solve_inputs(sched, cluster, **kw)
        plugin = sched.profile.plugins[0]
        plugin.bind_aux(plugin.aux())
        plugin.bind_presolve(plugin.prepare_solve(snap))
        raws.append(np.asarray(plugin.score(sched.initial_state(snap), snap,
                                            0)))
    np.testing.assert_array_equal(raws[1], raws[0])
    assert (int(raws[1][0]) > 0) == positive


def test_plugins_without_metrics_score_nothing():
    """With no metrics source the store's snapshot has no metrics table
    and every Trimaran plugin abstains, as in JAX."""
    cluster = PORT.scenarios.allocatable_scenario(4, 4)
    sched = Scheduler(port_config.load_profile({"plugins": [
        "TargetLoadPacking", "LoadVariationRiskBalancing",
        "LowRiskOverCommitment", "Peaks"]}))
    _, snap, _ = solve_inputs(sched, cluster, device="cpu")
    assert snap.metrics is None
    state0 = sched.initial_state(snap)
    assert all(p.score(state0, snap, 0) is None
               for p in sched.profile.plugins)


# --- the parity path --------------------------------------------------------

def config2_small(pkg):
    return pkg.scenarios.trimaran_scenario(256, 512), CONFIG2


def case_builder(name):
    return lambda pkg: trimaran_case(name, pkg.objects, pkg.Cluster)


PROBLEMS = {"config2_small": config2_small,
            **{name: case_builder(name) for name in CASES}}


@pytest.fixture(scope="module")
def solved():
    cache = {}

    def get(name):
        if name not in cache:
            (jc, config), (pc, _) = PROBLEMS[name](JAX), PROBLEMS[name](PORT)
            js = JScheduler(jax_config.load_profile(config))
            ps = Scheduler(port_config.load_profile(config))
            jpend, snap_j, _ = solve_inputs(js, jc)
            ppend, snap_p, _ = solve_inputs(ps, pc, device="cpu")
            state_j = js.initial_state(snap_j)
            snap_c = snapshot_from_numpy(jax_snapshot_tree(snap_j),
                                         device="cpu")
            state_c = state_from_numpy(numpy_tree(state_j), device="cpu")
            cache[name] = SimpleNamespace(
                js=js, ps=ps, jc=jc, pc=pc, jpend=jpend, ppend=ppend,
                snap_j=snap_j, snap_p=snap_p, snap_c=snap_c,
                state_c=state_c, res_j=js.solve(snap_j, state_j),
                res_c=ps.solve(snap_c, state_c, device="cpu"),
                res_p=ps.solve(snap_p, device="cpu"))
        return cache[name]

    return get


class TestSolveParity:
    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_lowering_equals_jax(self, solved, name):
        """The port lowers the cluster to JAX's tensors, metrics, limits
        and predictions included, in JAX's queue order."""
        s = solved(name)
        assert [p.uid for p in s.ppend] == [p.uid for p in s.jpend]
        want = s.snap_c.numpy()
        got = s.snap_p.numpy()
        assert got.keys() == want.keys()
        for table in got:
            for field, value in got[table].items():
                np.testing.assert_array_equal(
                    value, want[table][field], err_msg=f"{table}.{field}")
                assert value.dtype == want[table][field].dtype

    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_carried_inputs_equal_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_c, s.res_j)

    @pytest.mark.parametrize("name", sorted(PROBLEMS))
    def test_own_lowering_equals_jax_solve(self, solved, name):
        s = solved(name)
        assert_result_equal(s.res_p, s.res_j)
        assert (s.res_p.assignment >= 0).any()

    def test_the_cases_reach_their_branches(self, solved):
        """What each problem is there for: metrics on some nodes only,
        std-only and memory-only nodes, a node of no CPU, limits over
        requests, best-effort pods, a partial power model."""
        lroc = solved("lroc").snap_p
        m = lroc.metrics
        assert (~m.cpu_valid[:24]).any() and (m.cpu_valid
                                              & ~m.cpu_tlp_valid).any()
        assert (m.mem_valid & ~m.cpu_valid).any()
        assert lroc.nodes.capacity[0, 0] == 0
        assert (lroc.nodes.limits > lroc.nodes.requested).any()
        assert (lroc.pods.limits > lroc.pods.req).any()
        assert ((lroc.pods.req[:, :2] == 0).all(dim=1) & lroc.pods.mask).any()
        peaks = solved("peaks").ps.profile.plugins[0]
        assert 0 < int((peaks._k1 != 0).sum()) < len(solved("peaks").pc.nodes)
        tlp = solved("tlp_loaded")
        assert tlp.pc.tlp_prediction == (2.0, 1000)
        assert tlp.ps.profile.plugins[0].target == 60.0


class TestStepIssuesNoHostRead:
    """The config 2 step reads nothing on the host (the pattern of
    tests/test_torch_parity_solve.py): on the card it never waits."""

    HOST_READS = ("_local_scalar_dense", "nonzero", "is_nonzero",
                  "masked_select", "equal", "lift_fresh")

    @pytest.mark.parametrize("name", ["config2_small", "tlp_loaded",
                                      "peaks"])
    def test_no_host_reads(self, solved, name):
        s = solved(name)
        ops = []

        class Log(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.__name__)
                return func(*args, **(kwargs or {}))

        with Log():
            s.ps.solve(s.snap_c, s.state_c, device="cpu")
        assert ops
        assert not [op for op in ops if op.split(".")[0] in self.HOST_READS]


class TestExplain:
    @pytest.mark.parametrize("name", ["config2_small", "tlp_loaded", "lroc",
                                      "peaks"])
    def test_rows_equal_jax(self, solved, name):
        s = solved(name)
        idx = [0, 1, 7, len(s.ppend) // 2, len(s.ppend) - 1]
        want = s.js.explain_rows(s.snap_j, idx)
        got = s.ps.explain_rows(s.snap_p, idx, device="cpu")
        for field in want:
            np.testing.assert_array_equal(got[field], np.asarray(want[field]),
                                          err_msg=field)
        # the winner of pod 0, explained against the cycle-initial state,
        # is the solve's choice for it
        total = np.where(got["feasible"][0], got["total"][0], -(2 ** 62))
        assert int(np.argmax(total)) == int(s.res_p.assignment[0])

    @pytest.mark.parametrize("name", ["config2_small", "tlp_loaded"])
    def test_batched_rows_equal_jax(self, solved, name):
        """The batched explain reads TLP's and LVRB's float32 curves."""
        s = solved(name)
        idx = list(range(0, len(s.ppend), 7))
        want = jax_batch_explain_rows(s.js, s.snap_j, idx)
        got = batch_explain_rows(s.ps, s.snap_p, idx, device="cpu")
        for field in want:
            np.testing.assert_array_equal(got[field], np.asarray(want[field]),
                                          err_msg=field)


# --- the cycle ----------------------------------------------------------------

def trimaran_cycle_script(pkg):
    """TLP (defaultRequestsMultiplier 2) + LVRB over 12 metered nodes:
    cycle 1 binds the batch; cycle 2 (30 s later, inside the reporting
    interval) sees those binds as missing CPU; cycle 3 (past the interval)
    no longer does; cycle 4 (past the 5-minute horizon) GCs the binding
    cache. New pods arrive before each later cycle."""
    o = pkg.o
    rng = np.random.default_rng(11)
    c = pkg.Cluster()
    for i in range(12):
        c.add_node(o.Node(name=f"n{i:02d}", allocatable={
            "cpu": int(rng.integers(4, 17)) * 1000,
            "memory": int(rng.integers(8, 33)) * GIB, "pods": 30}))
    c.node_metrics = {f"n{i:02d}": {
        "cpu_avg": float(rng.uniform(5, 70)),
        "cpu_std": float(rng.uniform(0, 15)),
        "mem_avg": float(rng.uniform(5, 70))} for i in range(11)}

    def add(prefix, n, t0):
        def mutate(pkg, cluster):
            for k in range(n):
                lim = {"cpu": 1500} if k % 3 == 0 else {}
                cluster.add_pod(pkg.o.Pod(
                    name=f"{prefix}-{k}", creation_ms=t0 + k,
                    containers=[pkg.o.Container(
                        requests={"cpu": 100 * (1 + k % 7),
                                  "memory": (1 + k % 3) * GIB},
                        limits=lim)]))
        return mutate

    add("a", 20, 0)(pkg, c)
    sched = pkg.Scheduler(pkg.Profile(plugins=[
        pkg.plugins.TargetLoadPacking(default_requests_multiplier="2"),
        pkg.plugins.LoadVariationRiskBalancing()]))
    return c, sched, [(1000, None), (31_000, add("b", 10, 100)),
                      (90_000, add("c", 6, 200)),
                      (400_000, add("d", 4, 300))]


def test_cycle_matches_jax_with_compensation_and_gc():
    jc, js, jsteps = trimaran_cycle_script(JAX_CYCLE)
    pc, ps, psteps = trimaran_cycle_script(PORT_CYCLE)
    missing = []
    for k, ((now, jmut), (_, pmut)) in enumerate(zip(jsteps, psteps)):
        if jmut is not None:
            jmut(JAX_CYCLE, jc)
            pmut(PORT_CYCLE, pc)
        # what this cycle's snapshot will see, before the cycle's own GC
        want = jc._metrics_with_missing(now)
        assert pc._metrics_with_missing(now) == want, k
        missing.append(sum(m.get("missing_cpu_millis", 0)
                           for m in want.values()))
        jr = JAX_CYCLE.run(js, jc, now)
        pr = PORT_CYCLE.run(ps, pc, now)
        assert report_diff(jr, pr) == [], (k, jr, pr)
        assert store_diff(jc, pc) == [], (k, store_diff(jc, pc))
        assert list(pc.recent_bindings.items()) == list(
            jc.recent_bindings.items()), k
        assert pc.tlp_prediction == jc.tlp_prediction == (2.0, 1000)
        assert pr.bound, k
    # cycle 2 sees cycle 1's binds; cycle 3 only cycle 2's; cycle 4 none,
    # and the cache then holds only cycle 4's binds
    assert missing[0] == 0 and missing[1] > 0 and missing[3] == 0
    assert {ts for ts, _ in pc.recent_bindings.values()} == {400_000}


def test_cycle_snapshot_carries_missing_cpu():
    """After a cycle the next snapshot inside the reporting interval
    carries the bound pods' predicted CPU on their nodes, in both
    packages alike."""
    missing = []
    for pkg, kw in ((JAX_CYCLE, {}), (PORT_CYCLE, {"device": "cpu"})):
        c, s, steps = trimaran_cycle_script(pkg)
        pkg.run(s, c, steps[0][0])
        snap, _ = c.snapshot(c.pending_pods(), now_ms=31_000, **kw)
        missing.append(np.asarray(snap.metrics.missing_cpu_millis))
    np.testing.assert_array_equal(missing[1], missing[0])
    assert missing[1].sum() > 0


def test_streamed_cycle_falls_back_like_jax():
    """`run_cycle(stream_chunk=)` on TLP + LVRB: the profile fails the
    fast-path gate in both packages, so both run the sequential solve and
    agree."""
    jc, js, jsteps = trimaran_cycle_script(JAX_CYCLE)
    pc, ps, psteps = trimaran_cycle_script(PORT_CYCLE)
    jr = jax_cycle.run_cycle(js, jc, jsteps[0][0], 4)
    pr = port_cycle.run_cycle(ps, pc, psteps[0][0], 4, device="cpu")
    assert report_diff(jr, pr) == []
    assert store_diff(jc, pc) == []


def test_configure_cluster_runs_in_the_prologue():
    """A loaded TLP's DefaultRequestsMultiplier reaches the store at the
    start of the cycle, before the snapshot, as in JAX."""
    for objects, cluster_cls, load, run in (
            (jax_objects, JCluster, jax_config.load_profile,
             lambda s, c: jax_cycle.run_cycle(s, c, 1000)),
            (port_objects, PCluster, port_config.load_profile,
             lambda s, c: port_cycle.run_cycle(s, c, 1000, device="cpu"))):
        cluster, config = trimaran_case("tlp_loaded", objects, cluster_cls)
        assert cluster.tlp_prediction == (1.5, 1000)
        sched = (JScheduler if objects is jax_objects else Scheduler)(
            load(config))
        run(sched, cluster)
        assert cluster.tlp_prediction == (2.0, 1000)


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA card (CUDA is not available)")
        return torch.device("cuda")

    @pytest.fixture(autouse=True)
    def jax_package(self):
        """The card test needs no JAX: it overrides the module's guard."""

    @pytest.mark.parametrize("name", ("config2_small",) + CASES)
    def test_card_equals_cpu(self, card, name):
        """Each problem solved on the card, where a host read in the step
        raises (sync-debug "error"), equals the CPU's solve: every output
        and final carry, tolerance 0."""
        import scheduler_plugins_tpu_torch.models.scenarios as scenarios

        outs = []
        for device in (card, CPU):
            if name == "config2_small":
                cluster = scenarios.trimaran_scenario(256, 512)
                config = CONFIG2
            else:
                cluster, config = trimaran_case(name, port_objects, PCluster)
            sched = Scheduler(port_config.load_profile(config))
            _, snap, _ = solve_inputs(sched, cluster, device=device)
            if device.type == "cuda":
                torch.cuda.set_sync_debug_mode("error")
            try:
                result = sched.solve(snap, device=device)
            finally:
                if device.type == "cuda":
                    torch.cuda.set_sync_debug_mode("default")
            outs.append({k: None if v is None else v.cpu()
                         for k, v in parity_outputs(result).items()})
        for k in outs[1]:
            assert (outs[0][k] is None) == (outs[1][k] is None), k
            if outs[1][k] is not None:
                assert torch.equal(outs[0][k], outs[1][k]), k
