"""Server side of the Ray Client analog (port of
``ray_tpu/util/client/server.py``; reference
``util/client/server/proxier.py``).

Hosts ONE driver-style ``ClusterBackend`` on a cluster machine and proxies
a narrow RPC surface to remote clients. Per-session bookkeeping pins every
ObjectRef handed to a client until the client releases it or its session
ends, so the cluster's distributed ref counting sees the proxy as the
holder -- remote clients never touch a store or the ref protocol.

What departs from the reference (ROADMAP D-entry): its proxy unpickles
each call's ``(func, args, kwargs, options)`` and so must import the
client's code. The port's functions travel by reference, and a module
that only the client's ``working_dir`` holds cannot be imported here; so
the function, class, argument blobs and puts are handed to the backend
unopened (``serialization.Serialized``) and resolved in the worker, which
has the env, and a ``get`` returns the stored bytes undecoded
(``ClusterBackend.get(..., raw=True)``). Only the options are unpickled
here (the port's own types and plain data). The proxy packages a task's
``runtime_env`` on this host, as the reference's does.

``client_serve_stream`` runs a Serve token stream for the client
(reference :223): a prompt of ``PROMPT_SHM_MIN_TOKENS`` or more goes into
the store and the replica reads it back from its node's shared memory,
and keepalive frames flow while the stream waits for a slot.

A session ends on the client's ``bye`` or when it has not been heard from
for ``session_ttl_s`` (checked every quarter of it, at most every 5 s):
its pins drop, and the actors it created and did not name are killed.
"""

from __future__ import annotations

import threading
import time

from ray_tpu_torch.cluster.rpc import RpcServer
from ray_tpu_torch.core import serialization as ser

SESSION_TTL_S = 60.0


class _Session:
    __slots__ = ("refs", "actors", "last_seen")

    def __init__(self):
        # oid -> [ObjectRef, pin_count]: a COUNT, not a set -- the client
        # may hold several distinct refs to one oid (each with its own
        # release finalizer), and the pin must survive until the LAST one
        # is gone.
        self.refs: dict[str, list] = {}
        # Actors created by this session: killed when it ends, unless
        # named (another session may use a named actor).
        self.actors: set[str] = set()
        self.last_seen = time.monotonic()


class ClientProxyServer:
    def __init__(self, head_address: str, host: str = "127.0.0.1",
                 port: int = 0, session_ttl_s: float = SESSION_TTL_S):
        from ray_tpu_torch.cluster.client import ClusterBackend

        self.backend = ClusterBackend(head_address, log_to_driver=False)
        self._sessions: dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._ttl = session_ttl_s
        self._stop = threading.Event()
        self._server = RpcServer(self, host, port)
        self.address = self._server.address
        threading.Thread(target=self._reap_loop, daemon=True).start()

    def shutdown(self):
        self._stop.set()
        self._server.stop()
        self.backend.shutdown()

    def sessions(self) -> dict:
        """{session id: {"pins": refs pinned, "actors": [actor ids]}}."""
        with self._lock:
            return {sid: {"pins": sum(e[1] for e in s.refs.values()),
                          "actors": sorted(s.actors)}
                    for sid, s in self._sessions.items()}

    # -- sessions ----------------------------------------------------------

    def _session(self, sid: str) -> _Session:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                s = self._sessions[sid] = _Session()
            s.last_seen = time.monotonic()
            return s

    def _reap_loop(self):
        while not self._stop.wait(min(5.0, max(0.05, self._ttl / 4))):
            cutoff = time.monotonic() - self._ttl
            with self._lock:
                dead = [sid for sid, s in self._sessions.items()
                        if s.last_seen < cutoff]
                sessions = [self._sessions.pop(sid) for sid in dead]
            for s in sessions:
                self._teardown(s)

    def _teardown(self, s: _Session):
        """End of a session: dropping its refs releases the proxy's holds
        (the cluster frees what nothing else holds), and its UNNAMED
        actors are killed -- a crashed client must not leak actor workers.
        Named actors survive: other sessions may use them."""
        with self._lock:
            actors = list(s.actors)
            s.refs.clear()
        for actor_id in actors:
            try:
                info = self.backend._actor_info(actor_id, refresh=True)
            except Exception:
                # Unknown state must fail SAFE: skipping the kill leaks at
                # worst one worker; killing a named actor another session
                # uses breaks it.
                continue
            if info.get("name"):
                continue
            try:
                self.backend.kill_actor(actor_id)
            except Exception:
                pass

    # Pin bookkeeping runs under self._lock: per-connection server threads
    # race (the client's heartbeat releases while its main thread gets or
    # submits), and the count updates are check-then-act.

    def _track(self, sid: str, refs) -> list[list[str]]:
        s = self._session(sid)
        out = []
        with self._lock:
            for r in refs:
                entry = s.refs.get(r.id)
                if entry is None:
                    s.refs[r.id] = [r, 1]
                else:
                    entry[1] += 1
                out.append([r.id, r._owner])
        return out

    def _refs_of(self, s: _Session, oids: list) -> list:
        with self._lock:
            entries = [s.refs.get(o) for o in oids]
        return [e[0] if e is not None else self.backend.make_ref(o)
                for e, o in zip(entries, oids)]

    # -- rpc surface -------------------------------------------------------

    def rpc_client_hello(self, sid: str):
        self._session(sid)
        return {"server": "ray_tpu_torch-client-proxy", "ttl_s": self._ttl}

    def rpc_client_ping(self, sid: str):
        self._session(sid)
        return True

    def rpc_client_bye(self, sid: str):
        with self._lock:
            s = self._sessions.pop(sid, None)
        if s is not None:
            self._teardown(s)
        return True

    def rpc_client_put(self, sid: str, meta: bytes, data: bytes,
                       refs: list):
        ref = self.backend.put(ser.Serialized(data, refs, meta=meta))
        return self._track(sid, [ref])[0]

    def rpc_client_get(self, sid: str, oids: list, timeout) -> list:
        s = self._session(sid)
        stored = self.backend.get(self._refs_of(s, oids), timeout, raw=True)
        return [[meta, data] for meta, data in stored]

    def rpc_client_hold(self, sid: str, oid: str, owner: str = None):
        """The client deserialized a nested ref: pin it for the session."""
        self._track(sid, [self.backend.make_ref(oid, owner or None)])
        return True

    def rpc_client_release(self, sid: str, oids: list):
        s = self._session(sid)
        with self._lock:
            for o in oids:
                entry = s.refs.get(o)
                if entry is not None:
                    entry[1] -= 1
                    if entry[1] <= 0:
                        del s.refs[o]
        return True

    def rpc_client_submit_task(self, sid: str, fn: bytes, fn_refs: list,
                               name: str, args: bytes, arg_refs: list,
                               options: bytes) -> list:
        refs = self.backend.submit_task(
            ser.Serialized(fn, fn_refs, name),
            ser.Serialized(args, arg_refs), {}, **ser.loads(options))
        return self._track(sid, refs)

    def rpc_client_create_actor(self, sid: str, cls: bytes, cls_refs: list,
                                name: str, args: bytes, arg_refs: list,
                                options: bytes) -> str:
        actor_id = self.backend.create_actor(
            ser.Serialized(cls, cls_refs, name),
            ser.Serialized(args, arg_refs), {}, **ser.loads(options))
        s = self._session(sid)
        with self._lock:
            s.actors.add(actor_id)
        return actor_id

    def rpc_client_submit_actor_task(self, sid: str, actor_id: str,
                                     method: str, args: bytes,
                                     arg_refs: list, options: bytes) -> list:
        refs = self.backend.submit_actor_task(
            actor_id, method, ser.Serialized(args, arg_refs), {},
            **ser.loads(options))
        return self._track(sid, refs)

    def rpc_client_wait(self, sid: str, oids: list, num_returns: int,
                        timeout, fetch_local: bool):
        s = self._session(sid)
        ready, rest = self.backend.wait(
            self._refs_of(s, oids), num_returns, timeout, fetch_local)
        return [r.id for r in ready], [r.id for r in rest]

    def rpc_client_kill_actor(self, sid: str, actor_id: str,
                              no_restart: bool):
        return self.backend.kill_actor(actor_id, no_restart)

    def rpc_client_cancel(self, sid: str, oid: str, force: bool):
        s = self._session(sid)
        return self.backend.cancel(self._refs_of(s, [oid])[0], force)

    def rpc_client_get_named_actor(self, sid: str, name: str) -> str:
        return self.backend.get_named_actor(name)

    def rpc_client_cluster_resources(self, sid: str):
        return self.backend.cluster_resources()

    def rpc_client_available_resources(self, sid: str):
        return self.backend.available_resources()

    def rpc_client_nodes(self, sid: str):
        return self.backend.nodes()

    def rpc_client_kv(self, sid: str, op: str, *args):
        return getattr(self.backend, "kv_" + op)(*args)

    # Prompts of at least this many tokens ride the object store instead
    # of the actor call's frame: the proxy puts the list once and hands
    # the replica an ObjectRef, a same-node shared-memory read.
    PROMPT_SHM_MIN_TOKENS = 512

    def rpc_client_serve_stream(self, sid: str, deployment: str,
                                blob: bytes):
        """Server-streaming Serve call (``handle.stream()`` over
        ``ray://``): a generator handler, so the RPC layer ships a frame a
        token chunk, each client stream on its own connection onto this
        one driver backend. A shed raises as the stream's terminal
        error."""
        from ray_tpu_torch.serve import _private as sp

        args, kwargs, meta = ser.loads(blob)
        self._session(sid)
        prompt_ref = None
        if (args and isinstance(args[0], (list, tuple))
                and len(args[0]) >= self.PROMPT_SHM_MIN_TOKENS):
            prompt_ref = self.backend.put(list(args[0]))
            args = (prompt_ref,) + tuple(args[1:])

        def gen():
            # The closure pins prompt_ref until the engine has read it
            # (the submit's round trip ends before the first chunk).
            # Keepalive frames flow while the stream waits in a deep
            # admission queue, so the client's socket never starves.
            _pin = prompt_ref  # noqa: F841
            yield from sp.stream_call(
                deployment, tuple(args), dict(kwargs or {}), meta,
                backend=self.backend, keepalive_every=20.0)

        return gen()
