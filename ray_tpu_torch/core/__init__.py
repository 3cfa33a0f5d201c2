"""Core runtime: IDs, object refs, resources, cancellation and the local
in-process backend (port of ``ray_tpu/core``; the cluster backend and
serialization are not ported: the local backend never serializes)."""
