"""The rank-split path across processes: gloo ranks spawned on the CPU
(`parallel.launch.run_ranks`, a `file://` store under `tmp_path`, so
parallel test workers never share a port), each running one body of
`tests/torch_rank_cases.py`. Every rank's outputs are held, with tolerance
0, against the port's one-process solve and the JAX package's mesh solve on
the same numpy-made inputs:

- `sharded_wave_solve(snap, mesh, weights)` over S in {2, 3, 4, 8} ranks
  against the port's one-card `n_blocks=S` form and JAX (at S = 2 one
  case under the sanitizer, a clean checked call a rank): the cordoned
  19-node cluster and the gang + quota envelope at the default windows
  (JAX `batch_solve`), and with small rescue windows, a chunked carry and
  9 nodes over 8 ranks (JAX `sharded_wave_solve` on `make_node_mesh(S)`,
  its Pallas ring kernels in interpret mode);
- `sharded_batch_solve` and `sharded_profile_batch_solve` on a 2 x 4 mesh
  against JAX's on `make_mesh(8)` and the port's unsharded solves, with the
  mixed and metric rosters of `dryrun_multichip`, and every rank's
  `shard_snapshot` view against the addressable shard of JAX's;
- `wave_gang_solve(mesh=)` over 2 and 4 ranks against JAX's on a
  ("gangs",) CPU mesh (outputs and wave stats) and the port's unsharded
  solve;
- the 2-process launch recipe of `tests/multihost_child.py`: rank 1
  corrupts its copy before `broadcast_snapshot`, and the replicated
  assignment still equals the single-process solve.

Each world size is one spawn running all of its cases."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import scheduler_plugins_tpu.framework as jax_framework
import scheduler_plugins_tpu.models as jax_models
import scheduler_plugins_tpu.plugins as jax_plugins
import scheduler_plugins_tpu_torch.models as port_models
import torch_rank_cases as cases
from scheduler_plugins_tpu.gangs import topology as j_topology
from scheduler_plugins_tpu.gangs import waves as j_waves
from scheduler_plugins_tpu.parallel import make_mesh as j_make_mesh
from scheduler_plugins_tpu.parallel import solver as j_solver
from scheduler_plugins_tpu.parallel.mesh import shard_snapshot as j_shard
from scheduler_plugins_tpu_torch.gangs import topology as p_topology
from scheduler_plugins_tpu_torch.gangs import waves as p_waves
from scheduler_plugins_tpu_torch.parallel import solver as t_solver
from scheduler_plugins_tpu_torch.parallel.launch import run_ranks
from tests.test_torch_snapshot import mixed_cluster, snapshot_pair
from tests.test_torch_wave import RESCUE_WINDOW, jax_sharded, weights_of
from torch_gang_cases import cut_mega_shape, mega_gang_problem

CPU = "cpu"
GIB = 1 << 30
#: a spawn's deadline, seconds (a hung rank fails the test, never the run)
SPAWN_TIMEOUT_S = 240

JAX_PKG = SimpleNamespace(models=jax_models, plugins=jax_plugins,
                          Profile=jax_framework.Profile,
                          Scheduler=jax_framework.Scheduler)


def multihost_cluster(pkg):
    """`tests/multihost_child.py`'s 8-node / 32-pod problem."""
    o = pkg.objects
    c = pkg.Cluster()
    for i in range(8):
        c.add_node(o.Node(name=f"n{i}", allocatable={
            "cpu": 4000 + 500 * i, "memory": 32 * GIB, "pods": 20}))
    for j in range(32):
        c.add_pod(o.Pod(name=f"p{j}", creation_ms=j, containers=[
            o.Container(requests={"cpu": 700 + 37 * (j % 5),
                                  "memory": GIB})]))
    return c


def _np_all(out):
    return tuple(np.asarray(x) for x in out)


def assert_equal(got, want, label):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and (g == w).all(), (label, k)


@pytest.fixture(scope="module")
def problems():
    """{name: (snap_j, snap_t, weights)} of the wave and batch cases."""
    builds = {
        "nineteen": (lambda pkg: mixed_cluster(pkg, 3, n_nodes=19,
                                               n_pods=300), 19),
        "gangs": (lambda pkg: mixed_cluster(pkg, 6, gangs=True), 19),
        "nine": (lambda pkg: mixed_cluster(pkg, 4, n_nodes=9, n_pods=120,
                                           cordon=(0,)), 9),
        "gangs16": (lambda pkg: mixed_cluster(pkg, 6, n_nodes=16,
                                              gangs=True), 16),
        "multihost": (multihost_cluster, 8),
    }
    out = {}
    for name, (build, pad) in builds.items():
        snap_j, meta_j, snap_t, _ = snapshot_pair(build, pad_nodes=pad)
        out[name] = (snap_j, snap_t, weights_of(meta_j))
    return out


@pytest.fixture(scope="module")
def jax_batch(problems):
    """{name: JAX `batch_solve`'s outputs}: the oracle of the default
    windows (JAX's own gates hold its mesh solve equal to it)."""
    return {name: _np_all(j_solver.batch_solve(
        problems[name][0], jnp.asarray(problems[name][2], jnp.int64)))
        for name in ("nineteen", "gangs")}


#: label -> (problem, kwargs) of the wave cases; the ones with small
#: rescue windows are held against JAX `sharded_wave_solve` on an S-device
#: node mesh, the rest against JAX `batch_solve`
WAVE_CASES = {
    "nineteen": ("nineteen", {}),
    "gangs": ("gangs", {}),
    "small": ("nineteen", {"rescue_window": RESCUE_WINDOW}),
    "chunked": ("nineteen", {"chunk": 128, "rescue_window": RESCUE_WINDOW}),
    "nine": ("nine", {"rescue_window": RESCUE_WINDOW}),
}


def wave_cases(problems, S):
    """[(label, port tree, weights, kwargs)] of a world of S ranks."""
    labels = ["nineteen", "gangs", "small"]
    labels += {3: ["chunked"], 8: ["nine"]}.get(S, [])
    return [(label, problems[WAVE_CASES[label][0]][1].numpy(),
             problems[WAVE_CASES[label][0]][2], WAVE_CASES[label][1])
            for label in labels]


def check_wave(problems, jax_batch, S, results, sanitized=()):
    for label, tree, weights, kw in wave_cases(problems, S):
        name = WAVE_CASES[label][0]
        snap_j, snap_t, _ = problems[name]
        one_card = _np_all(t_solver.sharded_wave_solve(
            snap_t, torch.as_tensor(weights), S, **kw))
        want = (jax_sharded(snap_j, weights, S, **kw) if kw
                else jax_batch[name])
        assert_equal(one_card, want, ("one card vs JAX", label, S))
        blocks = []
        for rank, res in enumerate(results):
            got = res[label]
            assert_equal(got[:3], want, ("ranks vs JAX", label, S, rank))
            assert got[3] > 1
            blocks.append(got[4])
            # a sanitized case is one clean checked call a rank
            assert got[5] == ([{"sanitize": "sharded_wave_solve", "ok": True}]
                              if label in sanitized else []), (label, got[5])
        # the ranks hold the rank order's blocks, padding at the end
        ids = np.concatenate(blocks)
        n = int(snap_t.num_nodes)
        assert len(ids) % S == 0 and (ids[n:] == -1).all()
        assert sorted(ids[:n].tolist()) == list(range(n))


def gang_cases(S):
    problem = mega_gang_problem(cut_mega_shape(64, 24),
                                p_topology.RankGangState)
    fields = {f: np.asarray(getattr(problem["gangs"], f))
              for f in problem["gangs"].__dataclass_fields__}
    return [(f"wave{w}", fields, problem["free0"], problem["eq_used0"],
             problem["node_mask"], w) for w in (2 * S - 1, 8)]


def check_gangs(S, results):
    problem = mega_gang_problem(cut_mega_shape(64, 24),
                                j_topology.RankGangState)
    mesh = JMesh(np.asarray(jax.devices()[:S]), (j_waves.GANGS_AXIS,))
    for label, fields, free0, eq0, mask, wave in gang_cases(S):
        port_np = p_topology.RankGangState(**fields)
        unsharded = p_waves.wave_gang_solve(port_np, free0, eq0, mask,
                                            wave=wave, device=CPU)
        jstats = {}
        want = j_waves.wave_gang_solve(problem["gangs"], free0, eq0, mask,
                                       wave=wave, mesh=mesh, stats=jstats)
        assert_equal(unsharded, want, ("unsharded vs JAX", label))
        for rank, res in enumerate(results):
            got = res[label]
            assert_equal(got[:5], want, ("ranks vs JAX", label, S, rank))
            assert got[5] == jstats, (label, rank)


#: the wave cases the two-rank spawn runs under the sanitizer
SANITIZED = ("small",)


def test_two_ranks(problems, jax_batch, tmp_path):
    """S = 2: the wave cases (the small-window one under `SPT_SANITIZE=1`,
    the checked program with its kernels), the gang wave over 2 ranks, and
    the multi-host launch recipe."""
    snap_j, snap_t, w = problems["multihost"]
    calls = [("wave_rank", (wave_cases(problems, 2), CPU, SANITIZED)),
             ("gang_rank", (gang_cases(2),)),
             ("launch_rank", (snap_t.numpy(), w))]
    results = run_ranks(cases.run_all, 2, (calls,), workdir=tmp_path,
                        timeout_s=SPAWN_TIMEOUT_S)
    check_wave(problems, jax_batch, 2, [r[0] for r in results], SANITIZED)
    check_gangs(2, [r[1] for r in results])
    local = t_solver.batch_solve(snap_t, torch.as_tensor(w))[0].numpy()
    jax_local = np.asarray(j_solver.batch_solve(
        snap_j, jnp.asarray(w, jnp.int64))[0])
    assert (local == jax_local).all() and (local >= 0).sum() > 0
    for assignment, shape in (r[2] for r in results):
        assert shape == {"pods": 1, "nodes": 2}
        assert assignment.tolist() == local.tolist()


#: the smoke's broadcast north star, cut: (nodes, pods, chunk, rescue)
BROADCAST_CUT = (40, 300, 128, RESCUE_WINDOW)


def test_three_ranks(problems, jax_batch, tmp_path):
    """S = 3: an axis no node count divides, a chunked carry, and the
    smoke's broadcast wave solve (`broadcast_wave_rank`) at a cut size,
    equal to the one-process solves of the same cluster."""
    calls = [("wave_rank", (wave_cases(problems, 3),)),
             ("broadcast_wave_rank", BROADCAST_CUT)]
    results = run_ranks(cases.run_all, 3, (calls,), workdir=tmp_path,
                        timeout_s=SPAWN_TIMEOUT_S)
    check_wave(problems, jax_batch, 3, [r[0] for r in results])
    n_nodes, n_pods, chunk, rescue = BROADCAST_CUT
    cluster = port_models.allocatable_scenario(n_nodes, n_pods)
    pending = sorted(cluster.pending_pods(), key=lambda p: p.creation_ms)
    snap, meta = cluster.snapshot(pending, now_ms=0, device=CPU,
                                  pad_pods=-(-n_pods // chunk) * chunk)
    w = cases.flagship_weights(meta)
    kw = dict(chunk=chunk, rescue_window=rescue)
    want = _np_all(t_solver.sharded_wave_solve(snap, w, 3, **kw))
    assert_equal(want, _np_all(t_solver.batch_solve(snap, w, **kw)),
                 "one card vs batch_solve")
    for rank, res in enumerate(r[1] for r in results):
        assert_equal((res["assignment"], res["admitted"], res["wait"]),
                     want, ("broadcast", rank))
        # on the CPU the plain versions run: no launch is counted
        assert res["launches"] == {"block_offsets": 0, "elect_min": 0,
                                   "fused_election": 0}
        assert res["exchanges"]["calls"] >= 2 * res["waves"]


def test_four_ranks(problems, jax_batch, tmp_path):
    """S = 4: the wave cases and the gang wave over 4 ranks (a wave of 7
    lanes rounds up to 8)."""
    calls = [("wave_rank", (wave_cases(problems, 4),)),
             ("gang_rank", (gang_cases(4),))]
    results = run_ranks(cases.run_all, 4, (calls,), workdir=tmp_path,
                        timeout_s=SPAWN_TIMEOUT_S)
    check_wave(problems, jax_batch, 4, [r[0] for r in results])
    check_gangs(4, [r[1] for r in results])


ROSTER_SHAPE = (16, 32)


def test_eight_ranks(problems, jax_batch, tmp_path):
    """S = 8: the wave cases (9 nodes over 8 ranks among them), then the
    2 x 4 mesh's batch and roster solves and snapshot views."""
    batch = [(name, problems[name][1].numpy(), problems[name][2])
             for name in ("multihost", "gangs16")]
    rosters = [(name, *ROSTER_SHAPE) for name in cases.ROSTERS]
    calls = [("wave_rank", (wave_cases(problems, 8),)),
             ("batch_rank", (batch, rosters, tuple(cases.ROSTERS)))]
    results = run_ranks(cases.run_all, 8, (calls,), workdir=tmp_path,
                        timeout_s=SPAWN_TIMEOUT_S)
    check_wave(problems, jax_batch, 8, [r[0] for r in results])
    j_mesh = j_make_mesh(8)
    assert j_mesh.devices.shape == (2, 4)
    ranked = [r[1] for r in results]
    for label, tree, w in batch:
        snap_j, snap_t, _ = problems[label]
        want = _np_all(j_solver.sharded_batch_solve(
            snap_j, j_mesh, jnp.asarray(w, jnp.int64)))
        assert_equal(_np_all(t_solver.batch_solve(
            snap_t, torch.as_tensor(w))), want, ("unsharded", label))
        for rank, res in enumerate(ranked):
            assert_equal(res["batch"][label], want, (label, rank))
    port = cases.port_namespace()
    for name, n_nodes, n_pods in rosters:
        sched_j, snap_j, _ = cases.roster_problem(JAX_PKG, name, n_nodes,
                                                  n_pods, device=None)
        want = _np_all(j_solver.sharded_profile_batch_solve(
            sched_j, snap_j, j_mesh))
        sched_t, snap_t, meta_t = cases.roster_problem(port, name, n_nodes,
                                                       n_pods)
        assert_equal(_np_all(t_solver.profile_batch_solve(
            sched_t, snap_t, device=CPU)), want, ("unsharded", name))
        want_batch = _np_all(j_solver.sharded_batch_solve(
            snap_j, j_mesh, jnp.asarray(cases.flagship_weights(meta_t),
                                        jnp.int64)))
        assert_equal(_np_all(t_solver.batch_solve(
            snap_t, cases.flagship_weights(meta_t))), want_batch,
            ("unsharded batch", name))
        assert (want[0] >= 0).sum() > 0
        for rank, res in enumerate(ranked):
            assert_equal(res["roster"][name], want, (name, rank))
            assert_equal(res["roster_batch"][name], want_batch,
                         (name, "batch", rank))
        check_views(j_shard(snap_j, j_mesh), j_mesh, ranked, name)


def check_views(sharded_j, j_mesh, ranked, name):
    """Each rank's `shard_snapshot` view equals the addressable shard of
    JAX's `shard_snapshot` on the device at its mesh coordinates."""
    compared = 0
    for res in ranked:
        p, n = res["coords"]
        device = j_mesh.devices[p, n]
        for table, fields in res["views"][name].items():
            table_j = getattr(sharded_j, table, None)
            if table_j is None or not isinstance(fields, dict):
                continue
            for field, got in fields.items():
                leaf = getattr(table_j, field, None)
                if not isinstance(leaf, jax.Array):
                    continue
                shard = next(s for s in leaf.addressable_shards
                             if s.device == device)
                want = np.asarray(shard.data)
                got = np.asarray(got)
                assert got.shape == want.shape, (name, table, field, p, n)
                assert (got == want).all(), (name, table, field, p, n)
                compared += 1
    assert compared > 0
