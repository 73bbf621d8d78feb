"""The plain reference agrees with the port on a cut of each cell on the
CPU, and a wrong placement makes `correct` false."""

import pytest

from portbench.traffic import (NodeDelete, NodeSpec, PodGroupSpec, PodSpec,
                               QuotaSpec, SpreadSpec)

from pbhelpers import SMALL, cpu_run

CELLS = sorted(SMALL)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [11, 4_000_000_003])
def test_port_equals_reference_on_a_cut(name, seed):
    out = cpu_run(name, seed)
    numbers = out["numbers"]
    assert out["correct"], numbers
    assert numbers["cycles_compared_exactly"] >= 2
    assert out["record"].window_bound > 0


def test_streamed_path_serves_the_burst(monkeypatch):
    from scheduler_plugins_tpu_torch.framework import cycle as cycle_mod

    served = []
    real = cycle_mod.streamed_profile_solve

    def spy(*args, **kw):
        out = real(*args, **kw)
        served.append(out is not None)
        return out

    monkeypatch.setattr(cycle_mod, "streamed_profile_solve", spy)
    cpu_run("basic_5k.burst", 5, seconds=0.2)
    assert served and all(served)


def _node(i, zone):
    return NodeSpec(f"n{i}", 1000, 1 << 30, 110,
                    {"kubernetes.io/hostname": f"n{i}", "zone": zone})


def _pod(k, spread=(), labels=None):
    return PodSpec(uid=f"default/p{k}", name=f"p{k}", namespace="default",
                   creation_ms=k, priority=0, cpu_millis=300,
                   memory_bytes=1 << 20, labels=labels or {}, spread=spread)


def test_reference_fits_in_queue_order_lowest_index_first():
    from portbench.reference.greedy import Reference

    ref = Reference([_node(i, "a") for i in range(3)],
                    ["NodeResourcesAllocatable"])
    for k in range(10):
        ref.add(_pod(k))
    bound, reserved, preempted = ref.cycle()
    # three 300m pods a 1000m node, in node order; the tenth fits nowhere
    assert [bound[f"default/p{k}"] for k in range(9)] == \
        ["n0"] * 3 + ["n1"] * 3 + ["n2"] * 3
    assert [p.uid for p in ref.pending()] == ["default/p9"]
    assert reserved == {} and preempted == {}


def test_reference_spreads_across_zones():
    from portbench.reference.greedy import Reference

    nodes = [_node(0, "a"), _node(1, "a"), _node(2, "b"), _node(3, "c")]
    ref = Reference(nodes, ["NodeResourcesAllocatable", "PodTopologySpread"])
    zone = SpreadSpec(1, "zone", "DoNotSchedule", (("color", "blue"),))
    for k in range(3):
        ref.add(_pod(k, (zone,), {"color": "blue"}))
    bound, _, _ = ref.cycle()
    # maxSkew 1 over zones a, b, c: one pod a zone, the lowest node first
    assert sorted(bound.values()) == ["n0", "n2", "n3"]


@pytest.mark.parametrize("record", [
    PodGroupSpec("default", "gang", 3, 1),
    QuotaSpec("default", 1000, 1 << 30, 2000, 1 << 31),
    NodeSpec("n9", 1000, 1 << 30, 110, {}),
    NodeDelete("n0"),
    PodSpec(uid="default/p1", name="p1", namespace="default", creation_ms=1,
            priority=0, cpu_millis=300, memory_bytes=1 << 20, labels={},
            group="gang"),
], ids=lambda r: r.kind)
def test_reference_refuses_what_it_does_not_model(record):
    """Gangs, quotas and node events are another reference's: the greedy
    one raises rather than judge them as plain pods and nodes."""
    from portbench.reference.greedy import Reference

    ref = Reference([_node(0, "a")], ["NodeResourcesAllocatable",
                                      "Coscheduling", "CapacityScheduling"])
    with pytest.raises(NotImplementedError):
        ref.add(record)
    assert ref.pods == {}


def test_a_moved_bind_makes_correct_false(monkeypatch):
    """A wrong placement planted where the store records it."""
    from scheduler_plugins_tpu_torch.state import cluster as cluster_mod

    real_bind = cluster_mod.Cluster.bind

    def moved(self, uid, node_name, now_ms=0):
        names = list(self.nodes)
        node_name = names[(names.index(node_name) + 7) % len(names)]
        return real_bind(self, uid, node_name, now_ms)

    monkeypatch.setattr(cluster_mod.Cluster, "bind", moved)
    out = cpu_run("basic_5k.burst", 3)
    assert not out["correct"]
    assert out["numbers"]["placement_mismatch"] > 0


def test_outcome_comparison_counts_reservations_and_victims():
    """Reserved at a node is an outcome of its own, and a victim on one
    side only is a mismatch."""
    from portbench import check

    bound = {"a": "n0", "b": "n1"}
    assert check.placement_gap(bound, {}, dict(bound), {}) == 0
    # b reserved at n1 on one side, bound there on the other; c reserved
    # on one side, pending on the other
    assert check.placement_gap(bound, {}, {"a": "n0"},
                               {"b": "n1", "c": "n2"}) == 2
    mine = {"p": ("n0", ["v1", "v2"])}
    theirs = {"q": ("n1", ["v2", "v3"])}
    assert check.victims(mine) ^ check.victims(theirs) == {"v1", "v3"}
    assert check.victims({}) == set()
