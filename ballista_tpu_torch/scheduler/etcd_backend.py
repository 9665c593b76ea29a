"""etcd v3 state backend: the multi-scheduler / HA store.

Mirrors the reference's ``EtcdClient`` (ref
ballista/rust/scheduler/src/state/backend/etcd.rs:32-196): get/
get_from_prefix map to Range over ``[key, prefix_end)``, put to Put,
lock to the v3 Lock service under ``/ballista_global_lock`` (etcd.rs:85)
backed by a leased session, and watch to the Watch bidi stream — which,
unlike the Memory/Sqlite backends' in-process trigger, observes writes
from OTHER schedulers: that is the property that makes multi-scheduler
deployments work (docs/deployment.md "HA" runbook).

The wire protocol is the public etcd API subset in ``proto/etcd.proto``
(hand-registered method paths, same pattern as scheduler/rpc.py — the
image has protoc but no grpc_tools plugin). There is no etcd server in
this build image, so the integration test (tests/test_etcd_backend.py)
runs this client against an in-process fake speaking the same wire
protocol; against a real etcd only the endpoint changes.

Port of ``ballista_tpu/scheduler/etcd_backend.py``, unchanged, over the
port's verbatim copy of ``proto/etcd_pb2.py``: host-only code.
"""

from __future__ import annotations

import logging
import threading

import grpc

log = logging.getLogger(__name__)

from ballista_tpu_torch.proto import etcd_pb2 as epb
from ballista_tpu_torch.scheduler.rpc import _with_deadline, rpc_timeout_s
from ballista_tpu_torch.scheduler.state_backend import (
    StateBackendClient,
    Watch,
    WatchEvent,
)

GLOBAL_LOCK_NAME = b"/ballista_global_lock"  # ref etcd.rs:85
LOCK_LEASE_TTL_S = 30


def _is_ipv4_hostport(ep: str) -> bool:
    host, _, port = ep.rpartition(":")
    if not port.isdigit():
        return False
    parts = host.split(".")
    return len(parts) == 4 and all(
        p.isdigit() and int(p) < 256 for p in parts
    )


def prefix_end(prefix: bytes) -> bytes:
    """etcd range_end for "all keys with this prefix": the prefix with its
    last byte incremented (trailing 0xff bytes dropped, as etcd clients
    do); b"\\0" means "to the end of keyspace"."""
    b = bytearray(prefix)
    while b:
        if b[-1] < 0xFF:
            b[-1] += 1
            return bytes(b)
        b.pop()
    return b"\x00"


class _EtcdStub:
    """Hand-registered method paths for the etcd services used here. The
    v3lock service lives in package ``v3lockpb`` on a real etcd — the
    path is what crosses the wire, not our local message package."""

    def __init__(self, channel: grpc.Channel) -> None:
        def u(path, resp):
            # Every unary etcd call carries the default per-call deadline
            # (BALLISTA_RPC_TIMEOUT_S): an unreachable etcd member must
            # fail the call, not wedge the scheduler under its state
            # lock. The watch / lease_keep_alive STREAMS below stay
            # unbounded — their lifetime is the subscription's.
            return _with_deadline(channel.unary_unary(
                path,
                request_serializer=lambda r: r.SerializeToString(),
                response_deserializer=resp.FromString,
            ))

        self.range = u("/etcdserverpb.KV/Range", epb.RangeResponse)
        self.put = u("/etcdserverpb.KV/Put", epb.PutResponse)
        self.delete_range = u("/etcdserverpb.KV/DeleteRange",
                              epb.DeleteRangeResponse)
        self.lease_grant = u("/etcdserverpb.Lease/LeaseGrant",
                             epb.LeaseGrantResponse)
        self.lease_revoke = u("/etcdserverpb.Lease/LeaseRevoke",
                              epb.LeaseRevokeResponse)
        self.lock = u("/v3lockpb.Lock/Lock", epb.LockResponse)
        self.unlock = u("/v3lockpb.Lock/Unlock", epb.UnlockResponse)
        self.watch = channel.stream_stream(
            "/etcdserverpb.Watch/Watch",
            request_serializer=lambda r: r.SerializeToString(),
            response_deserializer=epb.WatchResponse.FromString,
        )
        self.lease_keep_alive = channel.stream_stream(
            "/etcdserverpb.Lease/LeaseKeepAlive",
            request_serializer=lambda r: r.SerializeToString(),
            response_deserializer=epb.LeaseKeepAliveResponse.FromString,
        )


class _EtcdLock:
    """Context manager over the v3 Lock service: a leased session + Lock
    on entry, Unlock + lease revoke on exit (a crashed holder's lock
    self-releases when the lease TTL expires — the distributed analogue
    of the reference dropping its etcd lock guard, etcd.rs:85-101)."""

    def __init__(self, stub: _EtcdStub) -> None:
        self._stub = stub
        self._key: bytes | None = None
        self._lease = 0
        self._ka_stop: threading.Event | None = None
        self._ka_call = None

    def _start_keepalive(self) -> None:
        """Refresh the lease while the lock is held — a critical section
        longer than the TTL must NOT let the lock self-release under us
        (the TTL exists only so a CRASHED holder frees it)."""
        stop = self._ka_stop = threading.Event()
        lease = self._lease

        def requests():
            while not stop.wait(LOCK_LEASE_TTL_S / 3):
                yield epb.LeaseKeepAliveRequest(ID=lease)

        try:
            call = self._ka_call = self._stub.lease_keep_alive(requests())

            def drain():
                try:
                    for _ in call:
                        pass
                except grpc.RpcError:
                    pass  # holder exit cancels the stream

            # exits when __exit__ cancels the keepalive stream: the
            # thread's lifetime IS the stream's
            threading.Thread(  # lifelint: transfer=stream-bounded
                target=drain, daemon=True,
                name="etcd-lock-keepalive").start()
        except grpc.RpcError:
            log.warning("etcd lease keepalive unavailable; lock relies on "
                        "TTL=%ss outliving the critical section",
                        LOCK_LEASE_TTL_S)

    def __enter__(self) -> "_EtcdLock":
        self._lease = self._stub.lease_grant(
            epb.LeaseGrantRequest(TTL=LOCK_LEASE_TTL_S)
        ).ID
        # Lock acquisition may legitimately wait out a CRASHED holder's
        # lease (TTL expiry frees it), so its deadline is wider than the
        # default unary deadline; timeout=None (deadline disabled) keeps
        # the historical unbounded wait.
        default = rpc_timeout_s()
        lock_timeout = (
            max(default, 2.0 * LOCK_LEASE_TTL_S) if default > 0 else None
        )
        self._key = self._stub.lock(
            epb.LockRequest(name=GLOBAL_LOCK_NAME, lease=self._lease),
            timeout=lock_timeout,
        ).key
        self._start_keepalive()
        return self

    def __exit__(self, *exc) -> None:
        if self._ka_stop is not None:
            self._ka_stop.set()
            if self._ka_call is not None:
                self._ka_call.cancel()
            self._ka_stop = self._ka_call = None
        try:
            if self._key is not None:
                self._stub.unlock(epb.UnlockRequest(key=self._key))
        finally:
            self._key = None
            if self._lease:
                lease, self._lease = self._lease, 0
                try:
                    self._stub.lease_revoke(epb.LeaseRevokeRequest(ID=lease))
                except grpc.RpcError:
                    pass  # TTL expiry will collect it
        return None


class _StreamWatch(Watch):
    """A Watch fed by the server's event stream instead of local
    _notify — events include other processes' writes."""

    def __init__(self, prefix: str, unsubscribe, cancel_stream) -> None:
        super().__init__(prefix, unsubscribe)
        self._cancel_stream = cancel_stream

    def stop(self) -> None:
        if not self._stopped:
            self._cancel_stream()
        super().stop()


class EtcdBackend(StateBackendClient):
    def __init__(self, urls: str) -> None:
        """``urls``: etcd endpoints, ``host:port[,host:port...]`` (same
        flag format as the reference's --etcd-urls). Multiple endpoints
        become a single multi-address gRPC target with round-robin pick —
        member failover is the channel's reconnect, not a client-side
        retry loop."""
        super().__init__()
        self.urls = urls
        endpoints = [u.strip() for u in urls.split(",") if u.strip()]
        if not endpoints:
            raise ValueError("empty etcd endpoint list")
        opts = []
        if len(endpoints) == 1:
            target = endpoints[0]
        elif all(_is_ipv4_hostport(e) for e in endpoints):
            # gRPC's name-syntax multi-address target; round_robin gets
            # every member address and the channel handles failover
            target = "ipv4:" + ",".join(endpoints)
            opts = [("grpc.lb_policy_name", "round_robin")]
        else:
            # hostname endpoints can't share one channel target; use the
            # first and say so rather than failing obscurely at first RPC
            target = endpoints[0]
            log.warning(
                "multiple hostname etcd endpoints %s: using %s only "
                "(front the cluster with one DNS name for failover)",
                endpoints, target,
            )
        self._channel = grpc.insecure_channel(target, options=opts)
        self._stub = _EtcdStub(self._channel)

    # -- KV ------------------------------------------------------------------
    def get(self, key: str) -> bytes | None:
        resp = self._stub.range(epb.RangeRequest(key=key.encode()))
        return resp.kvs[0].value if resp.kvs else None

    def get_from_prefix(self, prefix: str) -> list[tuple[str, bytes]]:
        p = prefix.encode()
        resp = self._stub.range(
            epb.RangeRequest(key=p, range_end=prefix_end(p), sort_order=1)
        )
        return [(kv.key.decode(), kv.value) for kv in resp.kvs]

    def put(self, key: str, value: bytes) -> None:
        self._stub.put(epb.PutRequest(key=key.encode(), value=bytes(value)))

    def delete(self, key: str) -> None:
        self._stub.delete_range(epb.DeleteRangeRequest(key=key.encode()))

    def lock(self):
        return _EtcdLock(self._stub)

    # -- watch ---------------------------------------------------------------
    def watch(self, prefix: str) -> Watch:
        p = prefix.encode()
        create = epb.WatchRequest(
            create_request=epb.WatchCreateRequest(
                key=p, range_end=prefix_end(p)
            )
        )
        done = threading.Event()

        def requests():
            yield create
            done.wait()  # hold the send side open until stop()

        call = self._stub.watch(requests())
        w = _StreamWatch(prefix, self._unwatch, lambda: (done.set(),
                                                         call.cancel()))
        created = threading.Event()

        def pump():
            try:
                for resp in call:
                    if resp.created:
                        created.set()
                    for ev in resp.events:
                        if ev.type == epb.Event.DELETE:
                            w._offer(WatchEvent(
                                "delete", ev.kv.key.decode(), None))
                        else:
                            w._offer(WatchEvent(
                                "put", ev.kv.key.decode(), ev.kv.value))
            except grpc.RpcError as e:
                if not done.is_set():
                    # NOT a local stop(): the server stream died. Surface
                    # it loudly — a scheduler silently blind to peer
                    # writes defeats the backend's purpose.
                    log.error("etcd watch on %r lost: %s; subscription "
                              "ends (restart the watch to resume)",
                              prefix, e)
            created.set()  # unblock the creator on early failure too
            w.stop()

        # exits when w.stop()/close() cancels the watch stream: the
        # thread's lifetime IS the stream's
        threading.Thread(  # lifelint: transfer=stream-bounded
            target=pump, daemon=True,
            name=f"etcd-watch-{prefix}").start()
        # Hand the watch out only after the server acknowledged it
        # (created=true): a put() racing watch() must not fall into the
        # gap before registration.
        created.wait(timeout=10)
        with self._watch_lock:
            self._watchers.append(w)
        return w

    def _notify(self, kind: str, key: str, value: bytes | None) -> None:
        # events arrive from the server stream; local echo would deliver
        # this process's writes twice
        pass

    def close(self) -> None:
        super().close()
        self._channel.close()
