"""The closed loop, the default generator of a mix (`mixes/<name>.json`
with no `generator` key): the pods bound at set-up, then per iteration
the pods that complete and the pods that arrive, both decided by what the
last cycle did.

A mix sets
- `fill`: "init_pods" (the configuration's `init_pods` on nodes drawn
  from the seed) or "pod_ceiling" (its `pod_ceiling` spread evenly over
  the nodes);
- `arrive`: "measure_pods" (a burst of the configuration's
  `measure_pods` each iteration) or "backlog" (the pending pods topped up
  to the mix's `backlog`);
- `complete`: "previous_arrivals" (the last iteration's arrivals) or
  "random_bound" (as many seeded-random bound pods as the last cycle
  bound);
- `warmup_share`: the share of an iteration's arrivals (at least one pod)
  that the set-up's warm-up iterations add: the window's own shape, cut.

A generator module has `make(traffic, mix)`, whose object gives
- `fill()`: the records applied at set-up, in order (`traffic` names the
  kinds): the pods bound at set-up, each with its `node`, and whatever
  objects they need;
- `events(loop)`: an iteration's (removals, arrivals, key): the uids of
  the pods it deletes, the records it adds, in order, and a key of ints
  and strings (tuples of them) from which
- `rebuild(key)` makes the same arrivals again, for the comparison, with
  no draw and no state of the run: every draw is made in `events`, and
  the key keeps it.
`harness.Loop` says what `loop` holds. Here the arrivals come from
`traffic.arrivals` and the key is (first serial, count)."""

from __future__ import annotations

import numpy as np


class ClosedLoop:
    def __init__(self, traffic, mix: dict):
        self.traffic = traffic
        self.mix = mix

    def fill(self) -> list:
        t, cfg, kind = self.traffic, self.traffic.config, self.mix["fill"]
        names = [n.name for n in t.nodes]
        tpl = cfg["init_pod_template"]
        if kind == "init_pods":
            count = int(cfg["init_pods"])
            where = t.rng["fill"].integers(0, len(names), size=count)
        elif kind == "pod_ceiling":
            count = int(cfg["pod_ceiling"])
            where = np.arange(count) % len(names)
        else:
            raise ValueError(f"unknown fill {kind!r}")
        return [t.pod(tpl, names[int(i)]) for i in where]

    def arrival_count(self, loop) -> int:
        kind = self.mix["arrive"]
        if kind == "measure_pods":
            n = int(self.traffic.config["measure_pods"])
        elif kind == "backlog":
            n = max(int(self.mix["backlog"]) - len(loop.pending), 0)
        else:
            raise ValueError(f"unknown arrive {kind!r}")
        if loop.warming:
            n = min(n, max(1, round(n * float(self.mix["warmup_share"]))))
        return n

    def completions(self, loop) -> list:
        kind = self.mix["complete"]
        if kind == "previous_arrivals":
            return list(loop.prev_arrivals)
        if kind == "random_bound":
            return loop.bound.draw(self.traffic.rng["events"],
                                   loop.last_bound)
        raise ValueError(f"unknown complete {kind!r}")

    def events(self, loop) -> tuple:
        removals = self.completions(loop)
        arrivals = self.traffic.arrivals(self.arrival_count(loop))
        first = arrivals[0].creation_ms if arrivals else 0
        return removals, arrivals, (first, len(arrivals))

    def rebuild(self, key) -> list:
        return self.traffic.rebuild(*key)


def make(traffic, mix: dict) -> ClosedLoop:
    return ClosedLoop(traffic, mix)
