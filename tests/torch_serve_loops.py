"""Deployments the port's Serve tests run on a cluster.

A cluster sends a deployment's class or function to its replica's worker
by reference (module and name, ``ray_tpu_torch/core/serialization.py``),
so they live at the top level of this importable module, decorated with
the port's ``serve.deployment`` (which resolves to what it wraps on load).
The local-backend tests use them too, and the two-package parity test
binds the same classes under each package's decorator.
"""

import os
import threading
import time

import ray_tpu_torch
from ray_tpu_torch import serve


class EchoPid:
    """(this replica's pid, x), after 50 ms."""

    def __call__(self, x):
        time.sleep(0.05)
        return (os.getpid(), x)


def double(x):
    return 2 * x


class Work:
    """x + 1 after 20 ms: the load of the replica-death test."""

    def __call__(self, x):
        time.sleep(0.02)
        return x + 1


Echo = serve.deployment(num_replicas=2, max_concurrent_queries=8)(EchoPid)
Double = serve.deployment(num_replicas=2, route_prefix="/double")(double)
WorkDep = serve.deployment(num_replicas=2, route_prefix="/work",
                           max_concurrent_queries=8)(Work)


# -- the two-package parity app ----------------------------------------------
# A DAGDriver over Shift(Scale), behind "/" and "/graph", plus a
# @serve.batch deployment behind "/batch" that reports the size of the
# batch each item rode in. Each package binds these plain classes with its
# own decorators (``parity_app``).


class Scale:
    def __call__(self, x):
        return x * 10


class Shift:
    def __init__(self, upstream, get):
        self.upstream = upstream
        self._get = get

    def __call__(self, x):
        return self._get(self.upstream.remote(x), timeout=30) + 1


class BatchedSizes:
    """Each item answers [item * 2, the size of its batch]. The batch
    forms under a barrier: the first batch waits until ``n_items`` have
    arrived (or 5 s), so the sizes are the same on any machine."""

    n_items = 8

    def __init__(self):
        self._seen = 0
        self._cv = threading.Condition()

    def _arrive(self):
        with self._cv:
            self._seen += 1
            self._cv.notify_all()
            self._cv.wait_for(lambda: self._seen >= self.n_items, 5.0)

    def handle_batch(self, items):
        return [[i * 2, len(items)] for i in items]

    def __call__(self, x):
        self._arrive()
        return self.handle_batch(x)


def parity_app(serve_mod):
    """Deploy the parity app on ``serve_mod`` (``ray_tpu.serve`` or
    ``ray_tpu_torch.serve``) on its package's runtime: a DAGDriver over
    Shift(Scale) at "/" and at "/graph", and the batch deployment at
    "/batch" (max_batch_size 4: 8 items form two batches of 4)."""
    import importlib

    pkg = importlib.import_module(serve_mod.__name__.rsplit(".", 1)[0])

    class _Batched(BatchedSizes):
        handle_batch = serve_mod.batch(
            max_batch_size=4, batch_wait_timeout_s=1.0)(
                BatchedSizes.handle_batch)

    scale = serve_mod.deployment(name="Scale")(Scale)
    shift = serve_mod.deployment(name="Shift")(Shift)
    graph = shift.bind(scale.bind(), pkg.get)
    serve_mod.run(serve_mod.DAGDriver.bind(graph), name="driver",
                  route_prefix="/")
    serve_mod.run(serve_mod.DAGDriver.bind(graph), name="graph",
                  route_prefix="/graph")
    serve_mod.run(serve_mod.deployment(
        name="batched", route_prefix="/batch",
        max_concurrent_queries=16)(_Batched).bind())
    return serve_mod.start_http_proxy()


class DeviceProbe:
    """A GPU replica's body: doubles ``x`` on this process's CUDA device
    and says where it ran."""

    def __call__(self, x):
        import torch

        t = torch.tensor(x, device="cuda") * 2
        return {"device": str(t.device), "value": t.cpu().tolist(),
                "pid": os.getpid()}


def _engine_class():
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    return LLMEngine


class LoadedEngine:
    """A deployment class: ``LLMEngine`` with its weights replaced in place
    by ``params`` (numpy, the JAX package's layout) before any request."""

    def __new__(cls, params, **kw):
        import torch

        eng = _engine_class()(**kw)

        def load(dst, src):
            for k, v in src.items():
                if isinstance(v, dict):
                    load(dst[k], v)
                else:
                    with torch.no_grad():
                        dst[k].copy_(torch.from_numpy(v.copy()))

        load(eng.params, params)
        return eng


def tiny_engine_app(params=None, **kw):
    """The tiny fp32 GPT-2 engine as deployment ``llm`` at "/llm" (the
    engine takes the deployment's name through ``set_deployment_name``),
    with ``params`` (numpy) loaded in place of its random weights when
    given."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config

    kw.setdefault("model", "gpt2")
    kw.setdefault("config", dataclasses.replace(GPT2Config.tiny(),
                                                dtype=torch.float32))
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache_len", 32)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_new_tokens", 6)
    kw.setdefault("device", "cpu")
    target = _engine_class() if params is None else LoadedEngine
    if params is not None:
        kw["params"] = params
    eng = serve.deployment(name="llm", max_concurrent_queries=32,
                           route_prefix="/llm")(target)
    return serve.run(eng.bind(**kw))

