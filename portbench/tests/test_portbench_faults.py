"""The comparison fails a run whose timed path is broken underneath: the
harness's look for a card is skipped and the rest of a run is driven on a
cut of each cell, with one fault planted in the program.

The faults a cell can have (one card, so no exchange between chips to
leave out): a step that returns its state unchanged (the bind stage
binds nothing; the snapshot's lowering leaves the assigned pods out; for
the served cell also a refresh that folds no delta),
half of the batch left out (the queue sort drops its second half), and an
answer altered where it is produced (every bind lands on another node)."""

import pytest


from pbhelpers import SMALL, cpu_run


def bind_nothing(monkeypatch):
    from scheduler_plugins_tpu_torch.framework import cycle as cycle_mod

    stages = tuple((name, (lambda ctx: None) if name == "bind" else fn)
                   for name, fn in cycle_mod._STAGES)
    monkeypatch.setattr(cycle_mod, "_STAGES", stages)


def half_batch(monkeypatch):
    from scheduler_plugins_tpu_torch.framework.runtime import Scheduler

    real = Scheduler.sort_pending

    def first_half(self, pods, cluster=None):
        out = real(self, pods, cluster)
        return out[:len(out) // 2]

    monkeypatch.setattr(Scheduler, "sort_pending", first_half)


def moved_bind(monkeypatch):
    from scheduler_plugins_tpu_torch.state.cluster import Cluster

    real = Cluster.bind

    def moved(self, uid, node_name, now_ms=0):
        names = list(self.nodes)
        return real(self, uid, names[(names.index(node_name) + 1)
                                     % len(names)], now_ms)

    monkeypatch.setattr(Cluster, "bind", moved)


def stale_refresh(monkeypatch):
    """The served engine drains its deltas and folds none: its resident
    columns stay as they were."""
    from scheduler_plugins_tpu_torch.serving import deltas

    real = deltas.DeltaSink.drain

    def dropped(self):
        real(self)
        return []

    monkeypatch.setattr(deltas.DeltaSink, "drain", dropped)


def lowering_without_usage(monkeypatch):
    """The snapshot's lowering returns the nodes' usage unchanged from
    empty: the store's assigned pods are left out."""
    from scheduler_plugins_tpu_torch.state.cluster import Cluster

    monkeypatch.setattr(Cluster, "_assigned_pods",
                        lambda self, exclude=frozenset(): [])


FAULTS = {"bind_nothing": bind_nothing, "half_batch": half_batch,
          "moved_bind": moved_bind,
          "lowering_without_usage": lowering_without_usage}


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_correct_false(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = cpu_run(name, 21)
    assert not out["correct"], out["numbers"]


def test_stale_served_state_makes_correct_false(monkeypatch):
    stale_refresh(monkeypatch)
    out = cpu_run("basic_5k.churn", 21)
    assert not out["correct"], out["numbers"]
