"""gRPC transport adapter for the cluster event feed (port of
`scheduler_plugins_tpu.bridge.grpc_feed`).

Same event schema as `bridge.feed` (that module's docstring is the wire
contract), carried over real gRPC (HTTP/2, multiplexing, deadlines) instead
of a raw TCP socket. No protobuf: messages are the JSON event/ack bytes with
identity (de)serializers — the widely-used "JSON codec" pattern — so agents
in any language with a gRPC stack can call it without generated stubs:

    service scheduler_plugins_tpu.Feed {
      rpc Apply  (bytes JSON event)         returns (bytes JSON ack);
      rpc Stream (stream bytes JSON event)  returns (stream bytes JSON ack);
    }

`Stream` acks every event in order, so an agent can pipeline a replay and
fence with one {"op": "sync"} at the end. Resource-version fencing and the
store lock are shared with any `FeedServer` attached to the same cluster
when you pass its `lock`/`rv_table`.

Streaming deltas: when the cluster carries the native columnar mirror
(`Cluster.attach_native_store`), the {"op": "drain_deltas"} query returns
ONLY the node rows touched since the last drain (`snapshot_store.cc`
dirty-row export) — a remote mirror polls `drain_deltas` over `Apply` (or
interleaves it on a `Stream`) and ingests O(changed) per cycle instead of
re-shipping the whole snapshot; `GrpcFeedClient.drain_deltas()` is the
client-side convenience.

grpcio is an optional dependency: importing this module is always safe; the
deferred `import grpc` raises ImportError only when constructing
`GrpcFeedServer` / `GrpcFeedClient` (the plain TCP feed keeps working).
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from scheduler_plugins_tpu_torch.bridge.feed import apply_event
from scheduler_plugins_tpu_torch.state.cluster import Cluster

#: the JAX package's service name: an agent speaks to either package
SERVICE = "scheduler_plugins_tpu.Feed"


class GrpcFeedServer:
    """gRPC front end applying the event protocol to a Cluster store."""

    def __init__(
        self,
        cluster: Cluster,
        host: str = "127.0.0.1",
        port: int = 0,
        lock: Optional[threading.Lock] = None,
        rv_table: Optional[dict] = None,
    ):
        import grpc  # deferred: optional dependency

        self.cluster = cluster
        self.lock = lock if lock is not None else threading.Lock()
        self.rv_table = rv_table if rv_table is not None else {}

        def _apply(raw: bytes) -> bytes:
            try:
                event = json.loads(raw)
                with self.lock:
                    ack = apply_event(
                        self.cluster, event, rv_table=self.rv_table
                    )
            except Exception as exc:
                ack = {"ok": False, "error": str(exc)}
            return json.dumps(ack).encode()

        def apply_unary(request, context):
            return _apply(request)

        def apply_stream(request_iterator, context):
            for request in request_iterator:
                yield _apply(request)

        ident = lambda b: b  # noqa: E731 — JSON codec: bytes through
        handler = grpc.method_handlers_generic_handler(
            SERVICE,
            {
                "Apply": grpc.unary_unary_rpc_method_handler(
                    apply_unary,
                    request_deserializer=ident,
                    response_serializer=ident,
                ),
                "Stream": grpc.stream_stream_rpc_method_handler(
                    apply_stream,
                    request_deserializer=ident,
                    response_serializer=ident,
                ),
            },
        )
        from concurrent import futures

        self._server = grpc.server(futures.ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="spt-grpc-feed"))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self.host = host

    def start(self):
        self._server.start()
        return self

    def stop(self, grace: float = 0.5):
        self._server.stop(grace)

    def run_cycle(self, scheduler, now=None, *, device=None):
        """One scheduling cycle holding the feed lock, on `device` (None =
        the CUDA card)."""
        from scheduler_plugins_tpu_torch.framework.cycle import run_cycle

        with self.lock:
            return run_cycle(scheduler, self.cluster, now, device=device)


class GrpcFeedClient:
    """Agent-side client for `GrpcFeedServer` (JSON codec, no stubs)."""

    def __init__(self, host: str, port: int):
        import grpc

        self._channel = grpc.insecure_channel(f"{host}:{port}")
        ident = lambda b: b  # noqa: E731
        self._apply = self._channel.unary_unary(
            f"/{SERVICE}/Apply",
            request_serializer=ident,
            response_deserializer=ident,
        )
        self._stream = self._channel.stream_stream(
            f"/{SERVICE}/Stream",
            request_serializer=ident,
            response_deserializer=ident,
        )

    def send(self, event: dict) -> dict:
        return json.loads(self._apply(json.dumps(event).encode()))

    def send_batch(self, events: list[dict]) -> list[dict]:
        payloads = (json.dumps(e).encode() for e in events)
        return [json.loads(ack) for ack in self._stream(payloads)]

    def drain_deltas(self) -> dict:
        """Pull the server store's streaming node-delta window (the rows
        touched since the last drain; O(changed), consumes the window)."""
        return self.send({"op": "drain_deltas"})

    def close(self):
        self._channel.close()
