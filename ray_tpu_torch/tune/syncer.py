"""Experiment-directory syncing to remote storage (port of
``ray_tpu/tune/syncer.py``).

Reference parity: ``python/ray/tune/syncer.py:185`` (``Syncer`` — the
abstraction that mirrors a local experiment directory to cloud/NFS
storage so experiments survive node loss and restore anywhere) and the
``storage_path`` URI handling in air/tune. Here: a ``Syncer`` base with
an incremental local/``file://`` implementation and an ``s3://`` stub
gated on boto3 (an optional dependency); ``get_syncer`` dispatches on
the URI scheme. ``RunConfig(storage_path="file://...")`` routes Tuner
persistence through a local mirror + sync-up, and ``Tuner.restore`` on a
URI syncs down first.
"""

from __future__ import annotations

import os
import shutil
import time


class Syncer:
    """Mirror a local directory to/from a remote URI."""

    #: Minimum seconds between periodic sync_up calls (final sync always
    #: runs).
    sync_period: float = 5.0

    def sync_up(self, local_dir: str, remote_uri: str) -> bool:
        raise NotImplementedError

    def sync_down(self, remote_uri: str, local_dir: str) -> bool:
        raise NotImplementedError

    def delete(self, remote_uri: str) -> bool:
        raise NotImplementedError

    def wait(self) -> None:
        """Block until any async sync completes (base impl is sync)."""


def _mirror(src: str, dst: str) -> None:
    """Incremental one-way mirror: copy files that are missing or newer
    (mtime+size) at the destination. Deletions do NOT propagate — an
    interrupted experiment must never erase its remote history."""
    os.makedirs(dst, exist_ok=True)
    for root, _dirs, files in os.walk(src):
        rel = os.path.relpath(root, src)
        out_root = os.path.join(dst, rel) if rel != "." else dst
        os.makedirs(out_root, exist_ok=True)
        for f in files:
            s = os.path.join(root, f)
            d = os.path.join(out_root, f)
            try:
                st = os.stat(s)
            except OSError:
                continue  # racing writer: next sync gets it
            if os.path.exists(d):
                dt = os.stat(d)
                if dt.st_mtime >= st.st_mtime and dt.st_size == st.st_size:
                    continue
            tmp = d + ".sync_tmp"
            shutil.copy2(s, tmp)
            os.replace(tmp, d)  # atomic: restorers never see partials


class FileSyncer(Syncer):
    """``file://`` / plain-path syncer (NFS mounts look like this too)."""

    @staticmethod
    def _path(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri

    def sync_up(self, local_dir: str, remote_uri: str) -> bool:
        _mirror(local_dir, self._path(remote_uri))
        return True

    def sync_down(self, remote_uri: str, local_dir: str) -> bool:
        remote = self._path(remote_uri)
        if not os.path.isdir(remote):
            return False
        _mirror(remote, local_dir)
        return True

    def delete(self, remote_uri: str) -> bool:
        shutil.rmtree(self._path(remote_uri), ignore_errors=True)
        return True


class S3Syncer(Syncer):
    """``s3://`` syncer. Requires boto3, an optional dependency: the
    constructor raises a clear error when it's absent, so experiments
    fail at configuration time rather than mid-run."""

    def __init__(self):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "s3:// storage_path requires boto3, which is not "
                "installed in this environment; use file:// or a plain "
                "path (NFS) instead"
            ) from e
        import boto3

        self._s3 = boto3.client("s3")

    @staticmethod
    def _bucket_key(uri: str):
        rest = uri[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        return bucket, prefix.rstrip("/")

    def sync_up(self, local_dir: str, remote_uri: str) -> bool:
        bucket, prefix = self._bucket_key(remote_uri)
        for root, _dirs, files in os.walk(local_dir):
            rel = os.path.relpath(root, local_dir)
            for f in files:
                key = "/".join(
                    p for p in (prefix, "" if rel == "." else rel, f) if p)
                self._s3.upload_file(os.path.join(root, f), bucket, key)
        return True

    def sync_down(self, remote_uri: str, local_dir: str) -> bool:
        bucket, prefix = self._bucket_key(remote_uri)
        paginator = self._s3.get_paginator("list_objects_v2")
        found = False
        for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
            for obj in page.get("Contents", []):
                found = True
                rel = obj["Key"][len(prefix):].lstrip("/")
                dest = os.path.join(local_dir, rel)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                self._s3.download_file(bucket, obj["Key"], dest)
        return found

    def delete(self, remote_uri: str) -> bool:
        bucket, prefix = self._bucket_key(remote_uri)
        paginator = self._s3.get_paginator("list_objects_v2")
        for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
            keys = [{"Key": o["Key"]} for o in page.get("Contents", [])]
            if keys:
                self._s3.delete_objects(
                    Bucket=bucket, Delete={"Objects": keys})
        return True


_SCHEMES = {"file": FileSyncer, "s3": S3Syncer}


def register_syncer(scheme: str, cls) -> None:
    _SCHEMES[scheme] = cls


def is_remote_uri(path: str) -> bool:
    scheme, sep, _ = path.partition("://")
    return bool(sep) and scheme in _SCHEMES


def get_syncer(uri: str) -> Syncer:
    scheme, sep, _ = uri.partition("://")
    if not sep:
        return FileSyncer()
    try:
        cls = _SCHEMES[scheme]
    except KeyError:
        raise ValueError(
            f"no syncer registered for scheme {scheme!r} "
            f"(known: {sorted(_SCHEMES)})") from None
    return cls()


class _PeriodicSync:
    """Throttled sync-up helper the TrialRunner drives after each
    persisted snapshot; ``final()`` always syncs."""

    def __init__(self, syncer: Syncer, local_dir: str, uri: str):
        self.syncer = syncer
        self.local_dir = local_dir
        self.uri = uri
        self._last = 0.0

    def maybe_sync(self) -> None:
        now = time.monotonic()
        if now - self._last >= self.syncer.sync_period:
            self._last = now
            self.syncer.sync_up(self.local_dir, self.uri)

    def final(self) -> None:
        self.syncer.sync_up(self.local_dir, self.uri)
