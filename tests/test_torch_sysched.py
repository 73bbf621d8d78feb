"""The port's SySched (`scheduler_plugins_tpu_torch.plugins.sysched`, the
snapshot's `SyscallState` and its lowering, the store's SeccompProfile
CRs) against the JAX package.

- The decision tables of `tests/test_sysched.py` and
  `tests/test_sysched_tables.py`, whole, run again with the JAX names
  they call (objects, store, scheduler, cycle, plugin, `parse_profile_path`,
  `default_normalize`, the `raw_plugin_scores` harness) replaced by the
  port's: profile resolution, host unions, the merge of references, the
  decomposition against the reference's set loop on random clusters, the
  normalize vectors.
- `SyscallState` field by field (values and dtypes) against JAX's on
  `tests/torch_roster_cases.roster_cluster` (the full 360-name universe,
  every way of naming a profile, with and without the all-syscalls
  default) and on `metric_affinity_scenario`.
- `SySched.score_batch` against the per-pod `score` row by row, and both
  against JAX's per-pod score vmapped over the pods; the reversed
  normalize of each row against JAX's; the 2^53 no-profile score through
  it.

Every quantity compared is an integer or a boolean: tolerance 0. The
`cuda`-marked test (`python -m pytest tests/test_torch_sysched.py -m
cuda`) runs `score_batch` on the card against the per-pod score on the
CPU; it needs no JAX."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import scheduler_plugins_tpu_torch.api.objects as port_objects
import scheduler_plugins_tpu_torch.framework.cycle as port_cycle
import scheduler_plugins_tpu_torch.plugins as port_plugins
from scheduler_plugins_tpu_torch.framework import Profile, Scheduler
from scheduler_plugins_tpu_torch.models import metric_affinity_scenario
from scheduler_plugins_tpu_torch.ops.normalize import default_normalize
from scheduler_plugins_tpu_torch.plugins import SySched
from scheduler_plugins_tpu_torch.plugins.sysched import NO_PROFILE_SCORE
from scheduler_plugins_tpu_torch.state import snapshot as port_snapshot
from scheduler_plugins_tpu_torch.state.cluster import Cluster as PCluster
from torch_roster_cases import roster_cluster, sysched_reference_rows

try:
    import jax
    import jax.numpy as jnp

    import scheduler_plugins_tpu.ops.normalize as j_normalize
    import scheduler_plugins_tpu.plugins as jax_plugins
    import scheduler_plugins_tpu.state.snapshot as j_snapshot
    import tests.conftest as jax_conftest
    import tests.test_sysched as jax_sysched
    import tests.test_sysched_tables as jax_sysched_tables
    from scheduler_plugins_tpu.framework import Scheduler as JScheduler
    from scheduler_plugins_tpu.framework import Profile as JProfile
    from tests.test_torch_snapshot import JAX, PORT
except ImportError:
    # a card machine may lack the JAX package's own dependencies
    JAX = None

CPU = torch.device("cpu")
SYSCALL_FIELDS = ("pod_sets", "has_profile", "host_sets", "counts",
                  "host_pod_count")


@pytest.fixture(scope="module", autouse=True)
def jax_package():
    if JAX is None:
        pytest.skip("the JAX package is not importable here")


# --- the JAX decision tables against the port ----------------------------------

class _CPUCluster(PCluster):
    def snapshot(self, pending, now_ms=0, device="cpu", **kw):
        return super().snapshot(pending, now_ms=now_ms, device=device, **kw)


class _CPUScheduler(Scheduler):
    def solve(self, snap, state0=None, *, device="cpu"):
        return super().solve(snap, state0, device=device)


def _port_raw_scores(cluster, sched, pod):
    """tests/conftest.py `raw_plugin_scores` on the port."""
    pending = sched.sort_pending(cluster.pending_pods(), cluster)
    snap, meta = cluster.snapshot(pending, now_ms=0)
    sched.prepare(meta, cluster)
    plugin = sched.profile.plugins[0]
    plugin.bind_presolve(plugin.prepare_solve(snap))
    state = sched.initial_state(snap)
    i = meta.pod_names.index(pod.uid)
    return plugin.score(state, snap, i).numpy(), meta


def _port_default_normalize(scores, mask, reverse=False):
    """`ops.normalize.default_normalize` of the port on the tables' JAX
    arrays, returning numpy."""
    return default_normalize(torch.as_tensor(np.array(scores)),
                             torch.as_tensor(np.array(mask)),
                             reverse=reverse).numpy()


def _tables():
    if JAX is None:
        return []
    classes = [jax_sysched.TestSySched, jax_sysched.TestProfileResolution,
               jax_sysched.TestScoreVectors,
               jax_sysched_tables.TestHostSyscallUnions,
               jax_sysched_tables.TestResolutionMerge,
               jax_sysched_tables.TestScoreDecompositionDifferential,
               jax_sysched_tables.TestNormalizeReferenceVectors]
    return [pytest.param(cls, name, id=f"{cls.__name__}.{name}")
            for cls in classes for name in sorted(vars(cls))
            if name.startswith("test_")]


@pytest.mark.parametrize("cls,method", _tables())
def test_reference_table_against_port(cls, method, monkeypatch):
    """Each case of the JAX SySched tables, with every JAX name the table
    calls swapped for the port's."""
    for module in (jax_sysched, jax_sysched_tables):
        for name in ("Container", "Node", "Pod", "SeccompProfile"):
            monkeypatch.setattr(module, name, getattr(port_objects, name))
        monkeypatch.setattr(module, "Cluster", _CPUCluster)
        monkeypatch.setattr(module, "Scheduler", _CPUScheduler)
        monkeypatch.setattr(module, "Profile", Profile)
        monkeypatch.setattr(module, "SySched", SySched)
    monkeypatch.setattr(
        jax_sysched, "run_cycle",
        lambda s, c, now=None, **kw: port_cycle.run_cycle(
            s, c, now=now, device="cpu", **kw))
    monkeypatch.setattr(j_snapshot, "parse_profile_path",
                        port_snapshot.parse_profile_path)
    monkeypatch.setattr(j_normalize, "default_normalize",
                        _port_default_normalize)
    for conftest in (jax_conftest, sys.modules.get("conftest")):
        if conftest is not None:
            monkeypatch.setattr(conftest, "raw_plugin_scores",
                                _port_raw_scores)
    getattr(cls(), method)()


# --- the syscall tables ----------------------------------------------------------

def lowered(build, names=("SySched",)):
    """Both packages' schedulers, queue-sorted batches, snapshots and
    metas of `build(pkg)`, each plugin's `configure_cluster` run first (as
    the cycle runs it) and the plugins prepared."""
    out = []
    for pkg, plugins, sched_cls, profile_cls, kw in (
            (JAX, jax_plugins, JScheduler, JProfile, {}),
            (PORT, port_plugins, Scheduler, Profile, {"device": "cpu"})):
        cluster = build(pkg)
        sched = sched_cls(profile_cls(plugins=[getattr(plugins, n)()
                                               for n in names]))
        for plugin in sched.profile.plugins:
            plugin.configure_cluster(cluster)
        pending = sched.sort_pending(cluster.pending_pods(), cluster)
        snap, meta = cluster.snapshot(pending, now_ms=0, **kw)
        sched.prepare(meta, cluster)
        out.append(SimpleNamespace(cluster=cluster, sched=sched,
                                   pending=pending, snap=snap, meta=meta))
    return out


BUILDS = {
    "roster": lambda pkg: roster_cluster(pkg, 32, 64),
    "roster_no_default": lambda pkg: roster_cluster(pkg, 24, 40, seed=2,
                                                    all_syscalls=False),
    "metric": lambda pkg: pkg.scenarios.metric_affinity_scenario(16, 32),
}


@pytest.fixture(scope="module")
def case():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = lowered(BUILDS[name])
        return cache[name]

    return get


class TestSyscallState:
    @pytest.mark.parametrize("name", sorted(BUILDS))
    @pytest.mark.parametrize("field", SYSCALL_FIELDS)
    def test_field_equals_jax(self, case, name, field):
        j, p = case(name)
        want = np.asarray(getattr(j.snap.syscalls, field))
        got = getattr(p.snap.syscalls, field).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)

    def test_full_universe_and_every_reference_kind(self, case):
        """The roster problem reaches what it is built for: the whole
        360-name universe, the all-syscalls fallback, every profile on
        some pod, empty and multi-pod hosts."""
        _, p = case("roster")
        sys_ = p.snap.syscalls
        assert sys_.pod_sets.shape[1] == 360
        assert sys_.has_profile[:64].all()
        sizes = sys_.pod_sets[:64].sum(1)
        # the fallback: a fifth of the pods name nothing, some of them
        # through an init container
        assert (sizes == 360).sum() >= 8
        assert len(set(sizes.tolist())) > 8
        assert (sys_.host_pod_count[:32] == 3).all()
        _, q = case("roster_no_default")
        assert not q.snap.syscalls.has_profile[:40].all()

    def test_universe_order_is_insertion_then_sorted(self):
        """Profiles in insertion order, each one's names sorted: a profile
        added later contributes its new names after the earlier ones'."""
        for pkg in (JAX, PORT):
            c = pkg.Cluster()
            c.add_node(pkg.objects.Node(name="n", allocatable={
                "cpu": 1000, "pods": 10}))
            c.add_seccomp_profile(pkg.objects.SeccompProfile(
                name="b", syscalls=frozenset({"zz", "aa"})))
            c.add_seccomp_profile(pkg.objects.SeccompProfile(
                name="a", syscalls=frozenset({"mm", "aa", "bb"})))
            pod = pkg.objects.Pod(name="p", containers=[
                pkg.objects.Container(seccomp_profile="a")])
            c.add_pod(pod)
            kw = {} if pkg is JAX else {"device": "cpu"}
            snap, _ = c.snapshot([pod], now_ms=0, **kw)
            row = np.asarray(snap.syscalls.pod_sets if pkg is JAX
                             else snap.syscalls.pod_sets.numpy())[0]
            # universe aa, zz, bb, mm
            assert row.tolist() == [True, False, True, True]

    def test_metric_scenario_same_cluster_as_jax(self):
        jc = JAX.scenarios.metric_affinity_scenario(12, 20, seed=5)
        pc = metric_affinity_scenario(12, 20, seed=5)

        def pods(c):
            return [(p.uid, dict(p.labels), p.effective_request(),
                     [ct.seccomp_profile for ct in p.containers],
                     p.node_name, len(p.pod_affinity_required),
                     [w.weight for w in p.pod_affinity_preferred])
                    for p in c.pods.values()]

        assert pods(pc) == pods(jc)
        assert pc.node_metrics == jc.node_metrics
        assert [(n.name, dict(n.labels)) for n in pc.nodes.values()] == [
            (n.name, dict(n.labels)) for n in jc.nodes.values()]
        assert list(pc.seccomp_profiles) == list(jc.seccomp_profiles)


# --- scores ------------------------------------------------------------------------

def jax_vmapped_scores(j):
    """JAX's per-pod score vmapped over every row of the batch, as JAX's
    `profile_batch_solve` evaluates it."""
    plugin = j.sched.profile.plugins[0]
    rows = jnp.arange(j.snap.pods.req.shape[0])
    return np.asarray(jax.vmap(
        lambda p: plugin.score(None, j.snap, p))(rows))


class TestScores:
    @pytest.mark.parametrize("name", sorted(BUILDS))
    def test_batch_equals_per_pod_and_jax(self, case, name):
        j, p = case(name)
        plugin = p.sched.profile.plugins[0]
        state = p.sched.initial_state(p.snap)
        batch = plugin.score_batch(state, p.snap)
        per_pod = torch.stack([plugin.score(state, p.snap, i)
                               for i in range(p.snap.num_pods)])
        assert batch.dtype == per_pod.dtype == torch.int64
        assert torch.equal(batch, per_pod)
        want = jax_vmapped_scores(j)
        assert want.dtype == np.int64
        np.testing.assert_array_equal(batch.numpy(), want)

    @pytest.mark.parametrize("name", sorted(BUILDS))
    def test_rows_equal_the_reference_formula(self, case, name):
        """The real pods' rows against the reference's set loop over the
        store's objects (`sysched_reference_rows`), not the
        decomposition."""
        _, p = case(name)
        plugin = p.sched.profile.plugins[0]
        rows = list(range(len(p.pending)))
        got = plugin.score_batch(None, p.snap)[rows][:, :len(
            p.meta.node_names)]
        want = sysched_reference_rows(p.cluster, p.pending, rows,
                                      p.meta.node_names)
        assert got.tolist() == want

    @pytest.mark.parametrize("name", sorted(BUILDS))
    def test_reversed_normalize_equals_jax(self, case, name):
        j, p = case(name)
        rng = np.random.default_rng(len(name))
        raw = jax_vmapped_scores(j)
        mask = rng.random(raw.shape) < 0.8
        want = np.asarray(jax.vmap(jax_plugins.SySched().normalize)(
            jnp.asarray(raw), jnp.asarray(mask)))
        got = p.sched.profile.plugins[0].normalize(
            torch.as_tensor(raw), torch.as_tensor(mask))
        np.testing.assert_array_equal(got.numpy(), want)

    def test_no_profile_score_and_its_normalize(self, case):
        """A pod with no profile and no default scores 2^53 on every
        node; the reversed normalize (x 100 inside int64) rates every
        node 0, in both packages."""
        j, p = case("roster_no_default")
        plugin = p.sched.profile.plugins[0]
        raw = plugin.score_batch(None, p.snap)
        none = ~p.snap.syscalls.has_profile
        assert none[:40].any()
        assert (raw[none] == NO_PROFILE_SCORE).all()
        mask = torch.ones_like(raw, dtype=torch.bool)
        norm = plugin.normalize(raw, mask)
        assert (norm[none] == 0).all()
        want = np.asarray(jax.vmap(jax_plugins.SySched().normalize)(
            jnp.asarray(raw.numpy()), jnp.asarray(mask.numpy())))
        np.testing.assert_array_equal(norm.numpy(), want)

    def test_empty_host_scores_zero(self, case):
        _, p = case("metric")
        raw = p.sched.profile.plugins[0].score_batch(None, p.snap)
        empty = p.snap.syscalls.host_pod_count == 0
        has = p.snap.syscalls.has_profile
        assert empty.any() and (raw[has][:, empty] == 0).all()


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

    def test_score_batch_on_card_equals_per_pod_on_cpu(self, card):
        """`score_batch` on the card (its float64 products included)
        equals the per-pod score on the CPU, row by row, tolerance 0,
        with no host read on the card."""
        pkg = SimpleNamespace(objects=port_objects, Cluster=PCluster)
        cluster = roster_cluster(pkg, 64, 128)
        plugin = SySched()
        plugin.configure_cluster(cluster)
        pending = cluster.pending_pods()
        snaps = [cluster.snapshot(pending, now_ms=0, device=d)[0]
                 for d in (card, CPU)]
        torch.cuda.set_sync_debug_mode("error")
        try:
            on_card = plugin.score_batch(None, snaps[0])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        per_pod = torch.stack([plugin.score(None, snaps[1], i)
                               for i in range(snaps[1].num_pods)])
        assert torch.equal(on_card.cpu(), per_pod)
