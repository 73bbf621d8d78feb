"""The generator is deterministic from the seed."""

from types import SimpleNamespace

from portbench.traffic import BoundSet

from pbhelpers import small_cell


def specs(cell, seed):
    traffic, generator = cell.traffic(seed)
    return ([(n.name, sorted(n.labels.items())) for n in traffic.nodes],
            [(p.uid, p.node) for p in generator.fill()],
            [p.uid for p in traffic.arrivals(5)])


def loop_view(bound, last_bound=0, pending=(), warming=False):
    """What a generator reads of `harness.Loop`."""
    return SimpleNamespace(bound=bound, last_bound=last_bound,
                           pending=dict.fromkeys(pending), warming=warming,
                           prev_arrivals=[])


def test_same_seed_same_cluster_and_events():
    cell = small_cell("spread_5k.burst")
    big = 3_000_000_017  # beyond 32 signed bits, as a run's --seed may be
    assert specs(cell, big) == specs(cell, big)


def test_seed_moves_zones_and_fill():
    cell = small_cell("spread_5k.burst")
    a, b = specs(cell, 1), specs(cell, 2)
    assert a[0] != b[0]
    assert a[1] != b[1]
    # the work is the same: the sizes and counts do not depend on the seed
    assert len(a[0]) == len(b[0]) and len(a[1]) == len(b[1])


def test_churn_completions_follow_the_seed():
    cell = small_cell("basic_5k.churn")

    def drawn(seed):
        _, generator = cell.traffic(seed)
        bound = BoundSet()
        for p in generator.fill():
            bound.add(p.uid)
        view = loop_view(bound, last_bound=16)
        return [generator.completions(view) for _ in range(3)]

    assert drawn(7) == drawn(7)
    assert drawn(7) != drawn(8)
    assert len(set(sum(drawn(7), []))) == 48  # distinct, 16 a draw


def test_backlog_is_topped_up_and_warmup_is_cut():
    cell = small_cell("basic_5k.churn")
    backlog = cell.mix["backlog"]
    _, generator = cell.traffic(3)
    view = loop_view(BoundSet(), pending=[f"p{k}" for k in range(5)])
    assert generator.arrival_count(view) == backlog - 5
    view.warming = True
    assert generator.arrival_count(view) == round(
        (backlog - 5) * cell.mix["warmup_share"])
    burst = small_cell("basic_5k.burst")
    _, generator = burst.traffic(3)
    view = loop_view(BoundSet(), warming=True)
    assert generator.arrival_count(view) == round(
        burst.config["measure_pods"] * burst.mix["warmup_share"])


def test_ceiling_fill_is_even():
    cell = small_cell("basic_5k.churn")
    _, generator = cell.traffic(0)
    per_node = {}
    for p in generator.fill():
        per_node[p.node] = per_node.get(p.node, 0) + 1
    assert set(per_node.values()) == {30}
