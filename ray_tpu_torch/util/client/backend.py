"""Client side of the Ray Client analog (port of
``ray_tpu/util/client/backend.py``; reference ``python/ray/util/client``).

Implements the process-wide Backend surface over RPC to a
``ClientProxyServer``: no shared memory, no cluster membership, no CUDA.
Selected by ``ray_tpu_torch.init(address="ray://host:port")``.

What crosses the wire is what this process serialized: a function or
class by reference (module and name, ``core/serialization.py``), the
arguments and puts as pickled bytes with the ids of the refs inside. The
proxy hands them to the cluster unopened, so it never imports this
process's code: a function that only a task's ``working_dir`` holds runs
although the proxy cannot import it. A ``get`` brings each value back as
the bytes the cluster stored, decoded here; a CUDA tensor a task returned
lands on the CPU (this process never initialises CUDA,
``core/serialization.py``).

Ref lifetime: every ObjectRef this backend mints carries a finalizer that
batches a release to the proxy (which holds the real refs); a heartbeat
thread keeps the session alive and carries the batched releases, and a
ref found inside a fetched value is pinned again on the proxy
(``client_hold``) before it is used. Streaming tasks
(``num_returns="streaming"``) have no path through the proxy, as in the
reference: they are refused at submit. A Serve token stream does
(``serve_stream``, reference :185-210): the proxy runs the routed stream
on the cluster and forwards each chunk over a server-streaming RPC.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Callable, Sequence

from ray_tpu_torch.cluster.rpc import ConnectionLost, RpcClient
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.object_ref import GetTimeoutError, ObjectRef


class ClientBackend:
    # An untimed get/wait must not ride one unbounded RPC: the transport's
    # per-connection socket timeout would sever it under a long task.
    # Block in bounded wait slices instead, then fetch.
    _SLICE_S = 20.0

    def __init__(self, address: str):
        self.address = address
        self.rpc = RpcClient(address)
        self.session_id = f"cs:{os.getpid()}:{os.urandom(4).hex()}"
        try:
            hello = self.rpc.call("client_hello", self.session_id)
        except BaseException:
            self.rpc.close()
            raise
        self._ttl = float(hello.get("ttl_s", 60.0))
        self._closed = threading.Event()
        # MUST be reentrant: _queue_release runs as a weakref.finalize
        # callback, so a GC pass can fire it on whatever thread is
        # allocating -- including the heartbeat thread while it holds
        # this lock (extend() allocates).
        self._release_lock = threading.RLock()
        self._pending_release: list[str] = []
        self._heartbeat = threading.Thread(
            target=self._heartbeat_loop, daemon=True)
        self._heartbeat.start()

    # -- plumbing ----------------------------------------------------------

    def _call(self, method: str, *args, timeout: float | None = None):
        return self.rpc.call(method, self.session_id, *args, timeout=timeout)

    def _heartbeat_loop(self):
        interval = max(1.0, self._ttl / 4)
        while not self._closed.wait(interval):
            # Batched ref releases ride the heartbeat.
            with self._release_lock:
                batch, self._pending_release = self._pending_release, []
            try:
                if batch:
                    self._call("client_release", batch)
                self._call("client_ping")
            except (ConnectionLost, OSError):
                with self._release_lock:
                    self._pending_release.extend(batch)

    def make_ref(self, oid: str, owner: str = "") -> ObjectRef:
        ref = ObjectRef(oid, owner)
        weakref.finalize(ref, self._queue_release, oid)
        return ref

    def _refs(self, pairs) -> list[ObjectRef]:
        return [self.make_ref(oid, owner) for oid, owner in pairs]

    def _queue_release(self, oid: str):
        if self._closed.is_set():
            return
        with self._release_lock:
            self._pending_release.append(oid)

    def on_ref_deserialized(self, oid: str, owner: str) -> ObjectRef:
        """A fetched value held a ref: pin it on the proxy so it outlives
        the value it came in."""
        try:
            self._call("client_hold", oid, owner)
        except (ConnectionLost, OSError):
            pass
        return self.make_ref(oid, owner)

    @staticmethod
    def _pickled(value) -> tuple[bytes, list[str]]:
        refs: list[str] = []
        return ser.dumps(value, found_refs=refs), refs

    # -- object plane ------------------------------------------------------

    def put(self, value: Any) -> ObjectRef:
        refs: list[str] = []
        meta, chunks = ser.serialize(value, found_refs=refs)
        pair = self._call("client_put", meta, b"".join(chunks), refs)
        return self._refs([pair])[0]

    def _wait_oids(self, oids, num_returns, timeout, fetch_local):
        if timeout is not None:
            return self._call(
                "client_wait", oids, num_returns, timeout, fetch_local,
                timeout=timeout + 15.0)
        while True:
            ready, rest = self._call(
                "client_wait", oids, num_returns, self._SLICE_S,
                fetch_local, timeout=self._SLICE_S + 15.0)
            if len(ready) >= num_returns:
                return ready, rest

    def get(self, refs: Sequence[ObjectRef], timeout: float | None = None):
        oids = [r.id for r in refs]
        uniq = list(dict.fromkeys(oids))
        _ready, rest = self._wait_oids(uniq, len(uniq), timeout, True)
        if rest:
            raise GetTimeoutError(
                f"{len(rest)}/{len(uniq)} objects not ready within "
                f"{timeout}s")
        # Everything exists on the cluster now: the fetch itself is quick.
        stored = self._call("client_get", oids, 30.0, timeout=60.0)
        values = []
        for meta, data in stored:  # errors raise in ref order
            value = ser.deserialize(meta[1:], data)
            if meta[:1] == b"E":
                raise value
            values.append(value)
        return values

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        by_id = {r.id: r for r in refs}
        ready, rest = self._wait_oids(
            [r.id for r in refs], num_returns, timeout, fetch_local)
        return [by_id[o] for o in ready], [by_id[o] for o in rest]

    # -- tasks / actors ----------------------------------------------------

    def submit_task(self, func: Callable, args: tuple, kwargs: dict,
                    **options) -> list[ObjectRef]:
        if options.get("num_returns") == "streaming":
            raise NotImplementedError(
                "num_returns='streaming' has no path through a ray:// "
                "client (the reference's client has none either); submit "
                "the streaming task from a driver on a cluster machine")
        fn, fn_refs = self._pickled(func)
        args_blob, arg_refs = self._pickled((args, kwargs))
        name = options.pop("name", "") or getattr(func, "__name__", "task")
        pairs = self._call("client_submit_task", fn, fn_refs, name,
                           args_blob, arg_refs, ser.dumps(options))
        return self._refs(pairs)

    def create_actor(self, cls: type, args: tuple, kwargs: dict,
                     **options) -> str:
        blob, cls_refs = self._pickled(cls)
        args_blob, arg_refs = self._pickled((args, kwargs))
        return self._call("client_create_actor", blob, cls_refs,
                          cls.__name__, args_blob, arg_refs,
                          ser.dumps(options))

    def submit_actor_task(self, actor_id: str, method_name: str,
                          args: tuple, kwargs: dict, *,
                          num_returns: int = 1,
                          **options) -> list[ObjectRef]:
        options["num_returns"] = num_returns
        args_blob, arg_refs = self._pickled((args, kwargs))
        pairs = self._call("client_submit_actor_task", actor_id,
                           method_name, args_blob, arg_refs,
                           ser.dumps(options))
        return self._refs(pairs)

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        self._call("client_kill_actor", actor_id, no_restart)

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        self._call("client_cancel", ref.id, force)

    def get_named_actor(self, name: str) -> str:
        return self._call("client_get_named_actor", name)

    # -- introspection / kv ------------------------------------------------

    def cluster_resources(self) -> dict:
        return self._call("client_cluster_resources")

    def available_resources(self) -> dict:
        return self._call("client_available_resources")

    def nodes(self) -> list:
        return self._call("client_nodes")

    def kv_put(self, key, value, overwrite=True):
        return self._call("client_kv", "put", key, value, overwrite)

    def kv_get(self, key):
        return self._call("client_kv", "get", key)

    def kv_del(self, key):
        return self._call("client_kv", "del", key)

    def kv_keys(self, prefix=""):
        return self._call("client_kv", "keys", prefix)

    # -- serve streaming ---------------------------------------------------

    def serve_stream(self, deployment: str, args: tuple, kwargs: dict,
                     meta=None):
        """A Serve token stream (``handle.stream()`` over ``ray://``): the
        proxy runs the routed stream on the cluster and forwards each
        chunk over a connection of its own, so concurrent streams
        multiplex; a shed on the cluster (``RequestShedError``) raises
        here, and the proxy's keepalive frames are dropped."""
        blob = ser.dumps((tuple(args), dict(kwargs or {}), meta))

        def gen():
            # The frame timeout outlives the proxy's keepalive cadence
            # (20 s), not the stream: a deep-queued stream stays quiet for
            # minutes while keepalives hold the socket.
            for item in self.rpc.call_stream(
                    "client_serve_stream", self.session_id, deployment,
                    blob, timeout=90.0):
                if isinstance(item, dict) \
                        and item.get("__stream_keepalive__"):
                    continue
                yield item

        return gen()

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self) -> None:
        self._closed.set()
        try:
            self._call("client_bye")
        except (ConnectionLost, OSError):
            pass
        self.rpc.close()
