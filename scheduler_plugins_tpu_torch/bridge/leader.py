"""Lease-based leader election against the kube-apiserver (port of
`scheduler_plugins_tpu.bridge.leader`).

The analog of the reference controller's leader election
(cmd/controller/app/server.go:56-58: controller-runtime's
LeaderElection with LeaderElectionID "sched-plugins-controllers" in
kube-system) — client-go leaderelection semantics over the
coordination.k8s.io/v1 Lease API, in plain HTTP:

- try to GET the Lease; 404 -> POST-create on the COLLECTION URL holding
  our identity (409 AlreadyExists = someone else won the create race);
- held by someone else and renewed within lease_duration_s -> standby;
- stale (renewTime older than leaseDurationSeconds) or already ours ->
  PUT carrying the observed metadata.resourceVersion — the optimistic-
  concurrency guard kube enforces: two racers GETting the same stale
  lease cannot both win, the second PUT gets 409 Conflict and stays on
  standby (client-go's resourceVersion-conditional update);
- on clean shutdown, release by clearing holderIdentity (client-go's
  ReleaseOnCancel), same conditional-update rules.

Clock skew caveat as upstream: expiry is judged by THIS client's clock
against the renewTime stamped by the holder.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from scheduler_plugins_tpu_torch.utils.httptls import ssl_context


def _micro_time(unix_s: float) -> str:
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(unix_s))
    return f"{base}.{int((unix_s % 1) * 1e6):06d}Z"


def _parse_micro_time(text: str) -> float:
    text = text.rstrip("Z")
    frac = 0.0
    if "." in text:
        text, frac_s = text.split(".", 1)
        frac = float(f"0.{frac_s}") if frac_s else 0.0
    import calendar

    return calendar.timegm(time.strptime(text, "%Y-%m-%dT%H:%M:%S")) + frac


class LeaseElector:
    """Single-Lease leader elector. Drive with `step(now)` (returns True
    while we hold the lease) or `run(stop_event)` in a thread."""

    def __init__(self, apiserver: str, identity: str,
                 name: str = "scheduler-plugins-tpu",
                 namespace: str = "kube-system",
                 lease_duration_s: float = 15.0,
                 renew_period_s: float = 5.0,
                 token: str = "",
                 ca_file: Optional[str] = None,
                 insecure_skip_verify: bool = False):
        self.apiserver = apiserver.rstrip("/")
        self.identity = identity
        self.name = name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.token = token
        self.ca_file = ca_file
        self.insecure_skip_verify = insecure_skip_verify
        self._leader_event = threading.Event()
        self.observed_holder: Optional[str] = None

    @property
    def is_leader(self) -> bool:
        """True while we hold the lease. Event-backed: the renew loop
        writes it from the elector thread while the scheduling loop and
        /healthz read it from theirs — a plain bool attribute is a
        cross-thread handoff with no synchronization;
        an Event is the one-word flag a leader gate is allowed to be."""
        return self._leader_event.is_set()

    @is_leader.setter
    def is_leader(self, value: bool) -> None:
        if value:
            self._leader_event.set()
        else:
            self._leader_event.clear()

    @property
    def _collection_url(self) -> str:
        return (f"{self.apiserver}/apis/coordination.k8s.io/v1/namespaces/"
                f"{self.namespace}/leases")

    @property
    def _url(self) -> str:
        return f"{self._collection_url}/{self.name}"

    def _request(self, method: str, url: str, body: Optional[dict] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        if self.token:
            req.add_header("Authorization", f"Bearer {self.token}")
        ctx = ssl_context(url, self.ca_file, self.insecure_skip_verify)
        with urllib.request.urlopen(req, timeout=5, context=ctx) as r:
            payload = r.read()
        return json.loads(payload) if payload else {}

    def _lease_body(self, spec: dict,
                    resource_version: Optional[str] = None) -> dict:
        meta = {"name": self.name, "namespace": self.namespace}
        if resource_version is not None:
            # conditional update: kube rejects the PUT with 409 Conflict
            # when someone replaced the lease since our GET
            meta["resourceVersion"] = str(resource_version)
        return {
            "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
            "metadata": meta,
            "spec": spec,
        }

    def step(self, now: Optional[float] = None) -> bool:
        """One acquire-or-renew attempt; updates and returns is_leader.
        Network errors and conditional-update conflicts demote to standby
        (fail-safe: a partitioned or out-raced ex-leader must stop acting
        before a peer takes over)."""
        now = time.time() if now is None else now
        try:
            try:
                lease = self._request("GET", self._url)
            except urllib.error.HTTPError as exc:
                if exc.code != 404:
                    raise
                try:
                    self._request("POST", self._collection_url,
                                  self._lease_body({
                                      "holderIdentity": self.identity,
                                      "leaseDurationSeconds": int(
                                          self.lease_duration_s),
                                      "acquireTime": _micro_time(now),
                                      "renewTime": _micro_time(now),
                                      "leaseTransitions": 0,
                                  }))
                except urllib.error.HTTPError as create_exc:
                    if create_exc.code == 409:  # lost the create race
                        self.is_leader = False
                        return False
                    raise
                self.is_leader = True
                self.observed_holder = self.identity
                return True

            spec = lease.get("spec") or {}
            holder = spec.get("holderIdentity") or None
            renew = spec.get("renewTime")
            self.observed_holder = holder
            fresh = (
                holder is not None
                and renew is not None
                and now - _parse_micro_time(renew)
                < float(spec.get("leaseDurationSeconds",
                                 self.lease_duration_s))
            )
            if holder not in (None, self.identity) and fresh:
                self.is_leader = False
                return False
            transitions = int(spec.get("leaseTransitions") or 0)
            if holder != self.identity:
                transitions += 1  # takeover/acquisition of a stale lease
            new_spec = {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": int(self.lease_duration_s),
                "acquireTime": (
                    spec.get("acquireTime", _micro_time(now))
                    if holder == self.identity else _micro_time(now)
                ),
                "renewTime": _micro_time(now),
                "leaseTransitions": transitions,
            }
            rv = (lease.get("metadata") or {}).get("resourceVersion")
            try:
                self._request("PUT", self._url,
                              self._lease_body(new_spec,
                                               resource_version=rv))
            except urllib.error.HTTPError as put_exc:
                if put_exc.code == 409:  # out-raced: stay on standby
                    self.is_leader = False
                    return False
                raise
            self.is_leader = True
            self.observed_holder = self.identity
            return True
        except Exception:
            self.is_leader = False
            return False

    def release(self) -> None:
        """Clear holderIdentity if we hold the lease (ReleaseOnCancel)."""
        if not self.is_leader:
            return
        try:
            lease = self._request("GET", self._url)
            spec = lease.get("spec") or {}
            if spec.get("holderIdentity") == self.identity:
                spec["holderIdentity"] = None
                rv = (lease.get("metadata") or {}).get("resourceVersion")
                self._request("PUT", self._url,
                              self._lease_body(spec, resource_version=rv))
        except Exception:  # graft-lint: ignore[GL010] — best-effort lease release on shutdown; the lease expires on its own
            pass
        self.is_leader = False

    def run(self, stop_event: threading.Event) -> None:
        """Renew loop until `stop_event`; releases on the way out."""
        while not stop_event.is_set():
            self.step()
            stop_event.wait(self.renew_period_s)
        self.release()
