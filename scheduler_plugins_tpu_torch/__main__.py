"""`python -m scheduler_plugins_tpu_torch` — the long-lived scheduler daemon
(port of `python -m scheduler_plugins_tpu`, flag for flag, plus `--device`).

The analog of the reference's two binaries in one process:

- the scheduler binary (cmd/scheduler/main.go:46-71):
  decode a profile, register plugins, run scheduling cycles against a live
  cluster store;
- the controller binary (cmd/controller/app/server.go:43-97):
  PodGroup/ElasticQuota reconcilers driven on the same cadence, plus a
  health/metrics surface.

Wiring per tick:

    apiserver (LIST+WATCH, bearer auth/ca)     [--apiserver URL]
        -> ClusterAgent reflector threads (one per watch path)
        -> FeedServer (rv-fenced event protocol over TCP; --grpc-port
           serves the same events over real gRPC/HTTP2; --native-store
           mirrors hot node columns into the C++ columnar store)
        -> Cluster store  (--scheduler-name gates the queue per profile)
    cycle loop:  [--leader-elect: only while holding the Lease]
                 run_cycle (QueueSort..Bind, collector ticks, NRT resync)
                 reconcile_pod_groups / reconcile_elastic_quotas
                 bindings POSTed back to the apiserver [--bind-back]
    health:      GET /healthz      -> liveness + cycle/bound/leader status
                 GET /metrics      -> prometheus text format (counters incl.
                                      per-plugin unschedulable attribution +
                                      cycle/plugin latency histograms)
                 GET /metrics.json -> the flat JSON counter snapshot

Without --apiserver the daemon is feed-driven: external agents (the Go/C++
sidecar shape, bridge/feed.py clients) push events to --feed-port and the
cycle loop schedules whatever arrives.

Snapshots and solves run on the CUDA card unless `--device cpu` asks for
the CPU; without a card and without `--device cpu` the daemon exits
non-zero at startup (`device.resolve_device`), never falling back.

`--max-cycles N` exits after N ticks (e2e tests; leader-election standby
ticks count, so bounded runs terminate either way); default runs until
SIGTERM/SIGINT, which stops cleanly (agents are daemon threads; the lease
is released, the feed/health servers shut down, a summary line prints).
"""

from __future__ import annotations

import argparse
import fnmatch
import json
import os
import signal
import sys
import threading
import time
import urllib.request

from scheduler_plugins_tpu_torch.api.config import load_profile
from scheduler_plugins_tpu_torch.bridge.agent import DEFAULT_WATCH_PATHS, ClusterAgent
from scheduler_plugins_tpu_torch.bridge.feed import FeedClient, FeedServer
from scheduler_plugins_tpu_torch.controllers.elasticquota import (
    reconcile_elastic_quotas,
)
from scheduler_plugins_tpu_torch.controllers.podgroup import reconcile_pod_groups
from scheduler_plugins_tpu_torch.device import resolve_device
from scheduler_plugins_tpu_torch.framework import Scheduler
from scheduler_plugins_tpu_torch.obs import ledger as podledger
from scheduler_plugins_tpu_torch.obs import memory
from scheduler_plugins_tpu_torch.state.cluster import Cluster
from scheduler_plugins_tpu_torch.utils import observability as obs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m scheduler_plugins_tpu_torch",
        description="Scheduler daemon on the CUDA card (feed server + "
                    "reflector agents + cycle loop + CRD controllers + "
                    "health).",
    )
    ap.add_argument("--profile", required=True,
                    help="profile file (YAML or JSON): {plugins: [...], "
                         "pluginConfig: [{name, args}...]}")
    ap.add_argument("--device", default=None,
                    help="torch device of the snapshots and solves "
                         "(default: the CUDA card, exiting non-zero "
                         "without one; `cpu` runs on the CPU)")
    ap.add_argument("--feed-host", default="127.0.0.1")
    ap.add_argument("--feed-port", type=int, default=0,
                    help="TCP port for the event feed (0 = ephemeral)")
    ap.add_argument("--grpc-port", type=int, default=None,
                    help="also serve the event feed over real gRPC/HTTP2 "
                         "on this port (requires grpcio; shares the store "
                         "lock and rv fence with the TCP feed)")
    ap.add_argument("--apiserver", default=None,
                    help="kube-apiserver base URL to LIST+WATCH (optional; "
                         "without it the daemon is feed-driven only)")
    ap.add_argument("--token-file", default=None,
                    help="bearer token file for --apiserver")
    ap.add_argument("--ca-file", default=None,
                    help="CA bundle to trust for --apiserver TLS "
                         "(in-cluster: the serviceaccount ca.crt)")
    ap.add_argument("--insecure-skip-verify", action="store_true")
    ap.add_argument("--watch-paths", default=None,
                    help="comma-separated resource paths to watch "
                         "(default: the full reference informer surface)")
    ap.add_argument("--bind-back", action="store_true",
                    help="POST bindings back to --apiserver "
                         "(pods/<name>/binding, the upstream bind shape)")
    ap.add_argument("--native-store", action="store_true",
                    help="mirror hot node columns into the C++ columnar "
                         "store (bridge/snapshot_store.cc, built with g++ "
                         "on first use) — snapshots read memcpy exports "
                         "instead of per-cycle Python accumulation")
    ap.add_argument("--scheduler-name", action="append", default=None,
                    help="profile name(s) this scheduler owns (repeatable; "
                         "default tpu-scheduler): only pods whose "
                         "spec.schedulerName matches are scheduled")
    ap.add_argument("--leader-elect", action="store_true",
                    help="coordination.k8s.io Lease leader election via "
                         "--apiserver: schedule only while holding the "
                         "lease (reflectors keep syncing on standby)")
    ap.add_argument("--lease-name", default="scheduler-plugins-tpu")
    ap.add_argument("--lease-namespace", default="kube-system")
    ap.add_argument("--lease-duration-s", type=float, default=15.0)
    ap.add_argument("--identity", default=None,
                    help="leader-election holder identity "
                         "(default hostname_pid)")
    ap.add_argument("--cycle-interval-s", type=float, default=1.0)
    ap.add_argument("--health-port", type=int, default=0,
                    help="HTTP health/metrics port (0 = ephemeral; "
                         "-1 disables)")
    ap.add_argument("--max-cycles", type=int, default=0,
                    help="exit after N cycles (0 = run until SIGTERM)")
    ap.add_argument("--record", type=int, default=0, metavar="N",
                    help="flight recorder: keep the last N scheduling "
                         "cycles' full solver inputs+outputs in a ring "
                         "buffer (utils.flightrec; 0 = off). Enables "
                         "GET /explain?uid=<pod-uid> on the health port "
                         "(per-plugin score table for any recorded pod)")
    ap.add_argument("--record-dir", default=None, metavar="DIR",
                    help="with --record: persist the ring as a replayable "
                         "bundle under DIR on shutdown (crash-safe "
                         "temp+rename writes; replay offline with "
                         "`python -m scheduler_plugins_tpu_torch.tools."
                         "replay`). NOTE: bundles carry full pod "
                         "specs — handle like an apiserver dump")
    ap.add_argument("--serve", action="store_true",
                    help="resident-state serving: keep node tensors "
                         "device-resident across cycles and ingest "
                         "O(changed) deltas (serving.engine.ServeEngine) "
                         "with periodic anti-entropy verification; falls "
                         "back to full snapshots transparently when the "
                         "profile surface needs them")
    ap.add_argument("--pipeline", action="store_true",
                    help="concurrent cycle pipeline "
                         "(framework.pipeline_cycle.PipelinedCycle): "
                         "dispatch the device solve asynchronously and "
                         "run the previous cycle's finalize in the "
                         "overlap window, with binds conflict-fenced at "
                         "the next ingest boundary; with --serve the "
                         "engine upgrades to the O(changed) "
                         "StreamingServeEngine (node-delete compaction, "
                         "memoized ingest, O(assigned) anti-entropy)")
    ap.add_argument("--lanes", type=int, default=0, metavar="K",
                    help="K-lane optimistic-concurrency scheduling "
                         "(framework.laned_cycle.LanedCycle): partition "
                         "the pending queue across K solver lanes by a "
                         "deterministic key (gang members never split), "
                         "solve all lanes speculatively against the same "
                         "resident state and commit through a single "
                         "host-side conflict fence in the defined serial "
                         "order — bit-identical to the serial cycle at "
                         "every K. Profiles outside the fence-exact gate "
                         "fall back to the sequential parity solve per "
                         "cycle (counted on /healthz). Mutually "
                         "exclusive with --pipeline")
    ap.add_argument("--tune", action="store_true",
                    help="online self-tuning shadow lane "
                         "(tuning.shadow.ShadowTuner): continuously "
                         "replay the recorded flight-recorder ring under "
                         "candidate plugin-weight vectors on a background "
                         "worker (deadlined — a hung sweep degrades to "
                         "'no tuning'), promote a winner only through "
                         "the tuning.promotion gates, roll it out live "
                         "via the aux channel (zero recompiles) and "
                         "auto-roll-back on quality-gauge regression "
                         "during probation. Implies --record 8 when "
                         "--record is not set (the ring IS the sweep "
                         "corpus). With --checkpoint, the promoted "
                         "weights + probation state persist to "
                         "<checkpoint>.tuner.json on shutdown and "
                         "restart resumes with them")
    ap.add_argument("--tune-candidates", type=int, default=24,
                    help="candidate weight vectors per shadow sweep")
    ap.add_argument("--tune-sweep-every", type=int, default=8,
                    help="cycles between shadow sweep dispatches")
    ap.add_argument("--resilient", action="store_true",
                    help="solve watchdog + degraded-mode failover "
                         "(resilience.watchdog): device solves complete "
                         "through a deadlined worker thread, retry with "
                         "seeded-jitter backoff, then fail over to the "
                         "host sequential parity path and probe for "
                         "recovery (SPT_SOLVE_TIMEOUT_S tunes the "
                         "deadline)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="with --serve: restore the resident state from "
                         "PATH at startup (if present; anti-entropy "
                         "verifies it before trusting it) and write a "
                         "final crash-safe checkpoint there on shutdown")
    ap.add_argument("--no-ledger", action="store_true",
                    help="disable the pod-lifecycle SLO ledger "
                         "(obs.ledger; on by default in the daemon). The "
                         "ledger follows each pod across cycles — queue "
                         "wait, backoff, gang wait, solve/fence/bind — "
                         "feeding the scheduler_e2e_scheduling_duration_ms "
                         "/ scheduler_pod_scheduling_sli_duration_ms "
                         "families, the /healthz sli block and "
                         "GET /pods/<uid>/timeline on the health port")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the cycle tracer for the daemon's "
                         "lifetime and flush a Perfetto-loadable JSON to "
                         "OUT.json on shutdown (SIGTERM included)")
    return ap.parse_args(argv)


def decode_profile_file(path: str) -> dict:
    """YAML/JSON profile file -> the flat {plugins, pluginConfig} mapping
    `api.config.load_profile` takes. Accepts a KubeSchedulerConfiguration
    -style {profiles: [first]} wrapper. Shared by startup profile loading
    and the flight recorder's exact-config capture, so the recorded
    config can never diverge from the profile the daemon actually runs.
    A file whose text is JSON parses with `json` (the mapping
    `yaml.safe_load` gives), so a JSON profile needs no PyYAML; any other
    text parses with `yaml`."""
    with open(path) as f:
        text = f.read()
    try:
        config = json.loads(text)
    except ValueError:
        import yaml

        config = yaml.safe_load(text)
    config = config or {}
    if "profiles" in config:
        config = (config.get("profiles") or [{}])[0]
    return config


def load_profile_file(path: str):
    """YAML/JSON profile file -> Profile."""
    return load_profile(decode_profile_file(path))


#: fnmatch patterns of the live thread names the daemon expects: the
#: interpreter's main thread, the stdlib servers' per-request threads
#: ("Thread-N (...)"), and every name the port's code assigns (one entry
#: each; tests/test_torch_daemon.py holds the code's names against it)
THREAD_PATTERNS = (
    "MainThread", "Thread-*",
    "agent-*", "feed-server", "health-server", "leader-elector",
    "load-watcher", "shadow-tuner", "solve-watchdog", "spt-bind-flusher*",
    "spt-grpc-feed*", "spt-lane-flusher*", "spt-lane-w*", "wd-*",
)


def thread_topology() -> dict:
    """Live thread names diffed against `THREAD_PATTERNS`. `unknown` names
    are topology drift: a running thread nobody declared."""
    live = sorted(t.name for t in threading.enumerate())
    unknown = [
        n for n in live
        if not any(fnmatch.fnmatch(n, p) for p in THREAD_PATTERNS)
    ]
    return {"live": live, "unknown": unknown}


class HealthServer:
    """GET /healthz (liveness + loop counters), /metrics (prometheus text
    exposition 0.0.4: counters incl. per-plugin unschedulable attribution,
    plus real `_bucket{le=...}`/`_sum`/`_count` histograms for cycle and
    per-extension-point plugin latency) and /metrics.json (the flat debug
    snapshot) — the probe/metrics surface of cmd/controller/app/server.go
    :52-58, now speaking the prometheus wire format."""

    def __init__(self, daemon, host: str, port: int):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        outer = daemon

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _json_reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    # lock-free: a probe must answer while a cycle (incl.
                    # first-compile) holds the feed lock; `last_pending`
                    # is the previous tick's cached count
                    payload = {
                        "ok": True,
                        "cycles": outer.cycles,
                        "bound_total": outer.bound_total,
                        "pending": outer.last_pending,
                        # latest cycle's placement-quality objectives
                        # (tuning.quality; None before the first solved
                        # cycle) — the gauge view lives on /metrics as
                        # scheduler_placement_quality{objective}
                        "quality": outer.last_quality,
                        "feed_address": list(outer.feed.address),
                        # degraded-mode serving state (resilience.watchdog):
                        # degraded=True means the device backend failed
                        # past the watchdog budget and cycles serve from
                        # the host parity path
                        "degraded": (
                            outer.resilience is not None
                            and outer.resilience.degraded
                        ),
                        "degraded_reason": (
                            outer.resilience.degraded_reason
                            if outer.resilience is not None else None
                        ),
                        "parked_cycles": outer.parked_cycles,
                        # pod-lifecycle SLIs (obs.ledger): e2e scheduling
                        # latency percentiles, per-stage decomposition
                        # totals and per-priority breakdown over the
                        # retired ring; None with --no-ledger
                        "sli": (
                            podledger.LEDGER.sli_summary()
                            if podledger.LEDGER.enabled else None
                        ),
                        # live thread census vs THREAD_PATTERNS:
                        # `unknown` = running threads nobody declared
                        "threads": thread_topology(),
                        # device-memory watermarks (obs.memory): the
                        # card's allocator bytes in use / peak, stamped by
                        # the last cycle; available=False on the CPU,
                        # None before the first cycle
                        "memory": outer.last_memory,
                    }
                    if payload["threads"]["unknown"]:
                        obs.metrics.inc(
                            obs.THREAD_TOPOLOGY_DRIFT,
                            len(payload["threads"]["unknown"]),
                        )
                    if outer.pipeline is not None:
                        # concurrent cycle pipeline introspection:
                        # configured depth + host stages still in
                        # flight (deferred finalize / unflushed binds)
                        payload["pipeline"] = {
                            "depth": outer.pipeline.depth,
                            "inflight": outer.pipeline.inflight,
                        }
                    if outer.laned is not None:
                        # K-lane engine introspection: lane config +
                        # conflict/re-resolve/fallback totals and the
                        # latest cycle's per-lane attribution
                        payload["lanes"] = outer.laned.stats()
                    if outer.engine is not None:
                        payload["serve"] = {
                            "generation": outer.engine.generation,
                            "rebases": outer.engine.rebases,
                            "antientropy_divergences":
                                outer.engine.antientropy_divergences,
                            # resident gang/quota serving health: >0
                            # means gang rosters are falling back to
                            # O(cluster) snapshots (should stay 0 on a
                            # compatible roster)
                            "gang_fallbacks":
                                outer.engine.gang_fallbacks,
                        }
                    if outer.tuner is not None:
                        # online self-tuning controller state (guarded
                        # rollout): active weights + digest, probation
                        # progress, promotion/rollback counters,
                        # self-disable reason
                        payload["tuner"] = outer.tuner.status()
                    if outer.elector is not None:
                        payload["leader"] = outer.elector.is_leader
                        payload["holder"] = outer.elector.observed_holder
                    body = json.dumps(payload).encode()
                elif self.path.startswith("/explain"):
                    # per-plugin score table for a recorded pod (flight
                    # recorder ring; 404 when off or uid not recorded)
                    from urllib.parse import parse_qs, urlparse

                    from scheduler_plugins_tpu_torch.utils import flightrec

                    query = parse_qs(urlparse(self.path).query)
                    uid = (query.get("uid") or [""])[0]
                    cycle = query.get("cycle")
                    try:
                        top_k = int((query.get("top") or [5])[0])
                        cycle_n = int(cycle[0]) if cycle else None
                    except ValueError as exc:
                        self._json_reply(
                            400, {"error": f"bad query parameter: {exc}"}
                        )
                        return
                    rec = flightrec.recorder.find(uid, cycle=cycle_n)
                    if not uid or rec is None:
                        detail = (
                            "flight recorder off (--record N)"
                            if not flightrec.recorder.enabled
                            else f"uid {uid!r} not in the recorded ring"
                        )
                        self._json_reply(404, {"error": detail})
                        return
                    try:
                        body = json.dumps(flightrec.explain_record(
                            rec, uid, top_k=top_k, device=outer.device
                        )).encode()
                    except Exception as exc:
                        self._json_reply(
                            500,
                            {"error": f"{type(exc).__name__}: {exc}"},
                        )
                        return
                elif self.path.startswith("/pods/"):
                    # GET /pods/<uid>/timeline — one pod's full lifecycle
                    # story from the pod ledger: events with (cycle, lane,
                    # seq) coordinates, the per-stage latency
                    # decomposition (sums to e2e exactly) and the meta of
                    # every cycle that observed the pod
                    from urllib.parse import unquote, urlparse

                    parts = urlparse(self.path).path.strip("/").split("/")
                    if len(parts) != 3 or parts[2] != "timeline":
                        self._json_reply(
                            404,
                            {"error": "expected /pods/<uid>/timeline"},
                        )
                        return
                    if not podledger.LEDGER.enabled:
                        self._json_reply(
                            404,
                            {"error": "pod-lifecycle ledger disabled "
                                      "(--no-ledger)"},
                        )
                        return
                    timeline = podledger.LEDGER.timeline(unquote(parts[1]))
                    if timeline is None:
                        self._json_reply(
                            404,
                            {"error": f"uid {unquote(parts[1])!r} not in "
                                      "the ledger (never pending, or "
                                      "aged out of the retired ring)"},
                        )
                        return
                    body = json.dumps(timeline).encode()
                elif self.path.startswith("/metrics.json"):
                    body = json.dumps(obs.metrics.snapshot()).encode()
                elif self.path.startswith("/metrics"):
                    body = obs.metrics.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.address = self._httpd.server_address
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="health-server",
        )
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class Daemon:
    def __init__(self, args):
        self.args = args
        try:
            # no silent fallback: without a card the caller asks for cpu
            self.device = resolve_device(args.device)
        except RuntimeError as exc:
            raise SystemExit(f"--device: {exc}")
        self.profile = load_profile_file(args.profile)
        self.scheduler = Scheduler(self.profile)
        if not getattr(args, "no_ledger", False):
            # pod-lifecycle SLO ledger (obs.ledger): O(changed) per cycle,
            # bounded ring — on by default in the daemon, feeding the
            # upstream-parity e2e/attempts/SLI metric families and the
            # /pods/<uid>/timeline surface
            podledger.LEDGER.start()
        if args.tune and not args.record:
            # the flight-recorder ring IS the shadow lane's sweep corpus
            args.record = 8
        if args.record:
            from scheduler_plugins_tpu_torch.utils import flightrec

            flightrec.recorder.start(capacity=args.record)
            # the daemon knows its EXACT profile config — record that
            # instead of the best-effort attribute export
            flightrec.recorder.profile_config = decode_profile_file(
                args.profile
            )
        self.cluster = Cluster()
        if args.scheduler_name:
            self.cluster.scheduler_names = set(args.scheduler_name)
        self.engine = None
        if args.serve:
            from scheduler_plugins_tpu_torch.serving import (
                ServeEngine,
                StreamingServeEngine,
            )

            engine_cls = (
                StreamingServeEngine if (args.pipeline or args.lanes)
                else ServeEngine
            )
            self.engine = engine_cls().attach(self.cluster)
            if args.checkpoint and os.path.exists(args.checkpoint):
                try:
                    self.engine.restore_checkpoint(args.checkpoint,
                                                   device=self.device)
                    obs.logger.info(
                        "resident state restored from %s (generation %d; "
                        "anti-entropy verifies at the first refresh)",
                        args.checkpoint, self.engine.generation,
                    )
                except Exception as exc:
                    # a bad checkpoint must never block startup: the
                    # engine just rebuilds from the store (cold path)
                    obs.logger.warning(
                        "checkpoint restore failed (%s): rebuilding "
                        "resident state from the store", exc,
                    )
        self.resilience = None
        if args.resilient:
            from scheduler_plugins_tpu_torch.resilience import Resilience

            self.resilience = Resilience(engine=self.engine)
        self.tuner = None
        if args.tune:
            from scheduler_plugins_tpu_torch.tuning.shadow import ShadowTuner

            try:
                self.tuner = ShadowTuner(
                    self.scheduler,
                    candidates=args.tune_candidates,
                    sweep_every=args.tune_sweep_every,
                    device=self.device,
                )
            except ValueError as exc:
                # e.g. a packing-mode profile: the rollout seam is the
                # sequential parity path — refuse at startup, clearly
                raise SystemExit(f"--tune: {exc}")
            if args.checkpoint and os.path.exists(
                self._tuner_state_path()
            ):
                try:
                    with open(self._tuner_state_path()) as f:
                        restored = self.tuner.restore_state(json.load(f))
                    if restored:
                        obs.logger.info(
                            "tuner state restored from %s: weights %s "
                            "(%s)", self._tuner_state_path(),
                            self.tuner.status()["active_weights"],
                            self.tuner.status()["state"],
                        )
                except Exception as exc:
                    # a bad state file must never block startup: the
                    # tuner just starts fresh on the profile weights
                    obs.logger.warning(
                        "tuner state restore failed (%s): starting from "
                        "the profile weights", exc,
                    )
        self.pipeline = None
        if args.pipeline:
            from scheduler_plugins_tpu_torch.framework import PipelinedCycle

            # binds flush inline (async_bind=False): every store
            # mutation happens under the feed lock the tick holds, so
            # the flusher thread's mutations cannot race feed ingest;
            # the overlap (async solve dispatch + the previous cycle's
            # finalize in the in-flight window) is within-tick
            self.pipeline = PipelinedCycle(
                self.scheduler, self.cluster, serve=self.engine,
                resilience=self.resilience, async_bind=False,
                device=self.device,
            )
        self.laned = None
        if args.lanes:
            if args.pipeline:
                raise SystemExit(
                    "--lanes and --pipeline are mutually exclusive "
                    "(both recompose the cycle around their own "
                    "concurrency model)"
                )
            if args.resilient:
                raise SystemExit(
                    "--lanes does not compose with --resilient: the "
                    "watchdog's degraded path IS the sequential engine "
                    "— lanes would add only fence overhead to it"
                )
            from scheduler_plugins_tpu_torch.framework import LanedCycle

            try:
                # binds flush inline (async_bind=False): every store
                # mutation happens under the feed lock the tick holds
                self.laned = LanedCycle(
                    self.scheduler, self.cluster, k=args.lanes,
                    serve=self.engine, async_bind=False,
                    device=self.device,
                )
            except ValueError as exc:
                raise SystemExit(f"--lanes: {exc}")
        if args.trace:
            obs.tracer.start()
        if args.native_store:
            try:
                self.cluster.attach_native_store()
            except Exception as exc:
                raise SystemExit(f"--native-store: {exc}")
        self.feed = FeedServer(
            self.cluster, host=args.feed_host, port=args.feed_port
        ).start()
        self.grpc_feed = None
        if args.grpc_port is not None:
            from scheduler_plugins_tpu_torch.bridge.grpc_feed import GrpcFeedServer

            # same lock + rv fence: redundant TCP/gRPC agents stay coherent
            self.grpc_feed = GrpcFeedServer(
                self.cluster, host=args.feed_host, port=args.grpc_port,
                lock=self.feed.lock, rv_table=self.feed.rv_table,
            ).start()
            if not self.grpc_feed.port:
                # grpc's add_insecure_port reports a bind failure as port
                # 0 instead of raising — fail fast like any bad config
                raise SystemExit(
                    f"--grpc-port {args.grpc_port}: bind failed "
                    "(port in use?)"
                )
        self.cycles = 0
        self.ticks = 0
        self.bound_total = 0
        self.last_pending = 0
        self.last_quality = None
        self.last_memory = None  # /healthz device-memory block
        self.parked_cycles = 0
        self._unposted: dict[str, str] = {}
        self.elector = None  # before HealthServer: /healthz reads it
        self.stop_event = threading.Event()
        self.health = None
        if args.health_port >= 0:
            self.health = HealthServer(self, args.feed_host, args.health_port)
        self.token = ""
        if args.token_file:
            with open(args.token_file) as f:
                self.token = f.read().strip()
        if args.leader_elect:
            if not args.apiserver:
                raise SystemExit("--leader-elect requires --apiserver")
            import socket as _socket

            from scheduler_plugins_tpu_torch.bridge.leader import LeaseElector

            identity = args.identity or (
                f"{_socket.gethostname()}_{os.getpid()}"
            )
            self.elector = LeaseElector(
                args.apiserver, identity,
                name=args.lease_name, namespace=args.lease_namespace,
                lease_duration_s=args.lease_duration_s,
                renew_period_s=max(args.lease_duration_s / 3.0, 0.05),
                token=self.token, ca_file=args.ca_file,
                insecure_skip_verify=args.insecure_skip_verify,
            )
            threading.Thread(
                target=self.elector.run, args=(self.stop_event,),
                daemon=True, name="leader-elector",
            ).start()
        self._agent_threads = []
        if args.apiserver:
            paths = (
                [p.strip() for p in args.watch_paths.split(",") if p.strip()]
                if args.watch_paths else list(DEFAULT_WATCH_PATHS)
            )
            for path in paths:
                t = threading.Thread(
                    target=self._agent_loop, args=(path,), daemon=True,
                    name=f"agent-{path}",
                )
                t.start()
                self._agent_threads.append(t)

    def _tuner_state_path(self) -> str:
        """The tuner's persisted controller state rides NEXT TO the
        resilience checkpoint (same crash-safe write discipline): the
        promoted weights + probation window survive a SIGTERM restart."""
        return f"{self.args.checkpoint}.tuner.json"

    def _agent_loop(self, path: str):
        """One reflector per watch path, feeding events through the real
        TCP wire to our own feed server (the exact path an external Go/C++
        agent would use)."""
        host, port = self.feed.address
        client = FeedClient(host, port)
        agent = ClusterAgent(client.send)
        agent.list_then_watch(
            self.args.apiserver, path,
            token=self.token,
            insecure_skip_verify=self.args.insecure_skip_verify,
            ca_file=self.args.ca_file,
            max_failures=None,  # the daemon retries for its lifetime
        )

    def _ssl_context(self):
        from scheduler_plugins_tpu_torch.utils.httptls import ssl_context

        return ssl_context(self.args.apiserver, self.args.ca_file,
                           self.args.insecure_skip_verify)

    def _post_binding(self, uid: str, node: str) -> bool:
        """POST the upstream Binding shape back to the apiserver (the bind
        goroutine's process boundary). Returns True when the retry-queue
        entry should be dropped — success, or a pod that no longer exists
        in the store (deleted since binding: nothing left to bind)."""
        with self.feed.locked():
            pod = self.cluster.pods.get(uid)
            if pod is None:
                return True
            ns, name = pod.namespace, pod.name
        url = (f"{self.args.apiserver.rstrip('/')}"
               f"/api/v1/namespaces/{ns}/pods/{name}/binding")
        body = json.dumps({
            "apiVersion": "v1", "kind": "Binding",
            "metadata": {"name": name, "namespace": ns},
            "target": {"apiVersion": "v1", "kind": "Node", "name": node},
        }).encode()
        req = urllib.request.Request(
            url, data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        try:
            urllib.request.urlopen(
                req, timeout=3, context=self._ssl_context()
            ).close()
        except Exception as exc:
            obs.logger.warning("binding POST failed for %s: %s", uid, exc)
            return False
        return True

    def tick(self, now_ms=None):
        """One scheduling tick at wall-clock `now_ms` (None = now): the
        cycle under the feed lock, the controllers, the bind-back POSTs
        and the device-memory stamp. Returns the cycle's report, or None
        on leader-election standby or a parked cycle."""
        if self.elector is not None and not self.elector.is_leader:
            # standby: reflectors keep the store warm, scheduling waits
            # (client-go leaderelection semantics — informers run, the
            # scheduling/reconcile loops gate on leadership)
            with self.feed.locked():
                self.last_pending = len(self.cluster.pending_pods())
            return None
        if now_ms is None:
            now_ms = int(time.time() * 1000)
        cycle_started = time.monotonic()
        try:
            engine = self.pipeline or self.laned
            if engine is not None:
                # the pipelined/laned engines compose their own stage
                # functions; the tuner's two seams wrap the whole tick
                # (weights may only change between ticks — the conflict
                # fence keeps any in-flight solve on the weights it
                # dispatched with)
                if self.tuner is not None:
                    self.tuner.begin_cycle(now_ms=now_ms)
                with self.feed.locked():
                    report = engine.tick(now_ms)
                if self.tuner is not None and report is not None:
                    self.tuner.observe_report(report)
            else:
                report = self.feed.run_cycle(
                    self.scheduler, now=now_ms, serve=self.engine,
                    resilience=self.resilience, tuner=self.tuner,
                    device=self.device,
                )
        except Exception as exc:
            from scheduler_plugins_tpu_torch.resilience import BackendUnavailable

            if not isinstance(exc, BackendUnavailable):
                raise
            # backend gone AND no host fallback for this profile: park
            # the cycle (pods stay pending, requeue backoff paces them)
            # and keep ticking — the probation probe restores the fast
            # path when the backend answers again
            obs.logger.warning("cycle parked: %s", exc.reason)
            self.parked_cycles += 1
            with self.feed.locked():
                self.last_pending = len(self.cluster.pending_pods())
            return None
        obs.metrics.observe_ms(
            "scheduler_cycle", (time.monotonic() - cycle_started) * 1000
        )
        with self.feed.locked():
            events = reconcile_pod_groups(self.cluster, now_ms=now_ms)
            events += reconcile_elastic_quotas(self.cluster)
            self.last_pending = len(self.cluster.pending_pods())
        for line in events:
            obs.logger.info("controller: %s", line)
        if report.bound or report.failed:
            obs.logger.info(
                "cycle %d: bound %d, unschedulable %d",
                self.cycles + 1, len(report.bound), len(report.failed),
            )
        if self.args.apiserver and self.args.bind_back:
            # the local store binds immediately; the apiserver POST is the
            # process boundary and can fail transiently — keep unacked
            # bindings in a retry queue until the POST lands (the local
            # pod is no longer pending, so no re-schedule would re-emit
            # it). Retries are capped per tick: during an apiserver
            # outage each attempt burns its connect timeout, and the
            # scheduling loop must keep its cadence
            self._unposted.update(report.bound)
            failures = 0
            for uid, node in list(self._unposted.items()):
                if failures >= 2:  # outage: stop burning connect timeouts
                    break
                if self._post_binding(uid, node):
                    del self._unposted[uid]
                else:
                    failures += 1
        self.cycles += 1
        self.bound_total += len(report.bound)
        if report.quality is not None:
            self.last_quality = report.quality
        # device-memory watermark gauges: one read of the allocator's host
        # counters per cycle (no device sync, no transfer)
        self.last_memory = memory.stamp_device_memory(obs.metrics)
        return report

    def run(self):
        args = self.args

        def handle_sig(signum, frame):
            self.stop_event.set()

        signal.signal(signal.SIGTERM, handle_sig)
        signal.signal(signal.SIGINT, handle_sig)

        host, port = self.feed.address
        status = {"feed": f"{host}:{port}"}
        if self.grpc_feed is not None:
            status["grpc"] = f"{self.grpc_feed.host}:{self.grpc_feed.port}"
        if self.health:
            status["health"] = "http://%s:%d/healthz" % self.health.address
        print("daemon ready " + json.dumps(status), flush=True)

        try:
            while not self.stop_event.is_set():
                started = time.monotonic()
                self.tick()
                self.ticks += 1
                # ticks, not scheduling cycles: a bounded run must also
                # terminate when leader-election standby skips every cycle
                if args.max_cycles and self.ticks >= args.max_cycles:
                    break
                remaining = args.cycle_interval_s - (
                    time.monotonic() - started
                )
                if remaining > 0:
                    self.stop_event.wait(remaining)
        finally:
            self.shutdown()

    def shutdown(self):
        """Graceful shutdown (the SIGTERM / SIGINT path, and the end of an
        in-process daemon): every artifact the process owns is flushed
        through the crash-safe `obs.atomic_write` discipline BEFORE the
        servers come down, then the exit path returns rc 0 — a drained,
        checkpointed daemon is indistinguishable from one that never
        ran."""
        self.stop_event.set()
        if self.pipeline is not None:
            try:
                # conflict-fence + deferred finalize of the last
                # in-flight cycle: a drained pipeline leaves the
                # store and the recorder exactly as the serial
                # engine would
                with self.feed.locked():
                    self.pipeline.close()
            except Exception as exc:
                obs.logger.warning("pipeline flush failed: %s", exc)
        if self.laned is not None:
            try:
                # join the lane bind flusher and shut the lane pool
                with self.feed.locked():
                    self.laned.close()
            except Exception as exc:
                obs.logger.warning("lane flush failed: %s", exc)
        if self.args.record and self.args.record_dir:
            from scheduler_plugins_tpu_torch.utils import flightrec

            try:
                summary = flightrec.recorder.save(self.args.record_dir)
                obs.logger.info("flight recorder bundle: %s", summary)
            except Exception as exc:
                obs.logger.warning("flight recorder save failed: %s", exc)
        if self.args.trace and obs.tracer.enabled:
            try:
                obs.tracer.stop()
                obs.tracer.write(self.args.trace)  # atomic_write inside
            except Exception as exc:
                obs.logger.warning("tracer flush failed: %s", exc)
        if self.engine is not None and self.args.checkpoint:
            try:
                if self.engine.save_checkpoint(self.args.checkpoint):
                    obs.logger.info(
                        "resilience checkpoint written: %s",
                        self.args.checkpoint,
                    )
            except Exception as exc:
                obs.logger.warning("checkpoint write failed: %s", exc)
        if self.tuner is not None and self.args.checkpoint:
            # currently-promoted weights + probation state persist
            # with the resilience checkpoint; restart resumes them
            try:
                obs.atomic_write(
                    self._tuner_state_path(),
                    json.dumps(self.tuner.state_dict(), sort_keys=True)
                    + "\n",
                )
                obs.logger.info(
                    "tuner state written: %s", self._tuner_state_path()
                )
            except Exception as exc:
                obs.logger.warning("tuner state write failed: %s", exc)
        if self.elector is not None:
            self.elector.release()  # ReleaseOnCancel (idempotent)
        if self.health:
            self.health.stop()
        if self.grpc_feed is not None:
            self.grpc_feed.stop()
        self.feed.stop()
        print(json.dumps({
            "daemon_exit": True,
            "cycles": self.cycles,
            "bound_total": self.bound_total,
            "parked_cycles": self.parked_cycles,
            "degraded": (
                self.resilience is not None and self.resilience.degraded
            ),
        }), flush=True)


def main(argv=None):
    daemon = Daemon(parse_args(argv))
    daemon.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
