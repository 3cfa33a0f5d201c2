"""Functions, classes and training loops that the data library's cluster
tests (``tests/test_torch_data_cluster.py``) send to worker processes.

The port sends functions and classes to workers by reference (module and
name), so whatever a plan or a loop runs on a ``Cluster`` lives here, at
the top level of an importable module.
"""

import numpy as np


def plus_one(x):
    return x + 1


def is_even(x):
    return x % 2 == 0


def twice(x):
    return [x, x]


def with_square(batch):
    return {"data": batch["data"], "sq": batch["data"] ** 2}


def key_mod3(r):
    return r % 3


class AddOffset:
    """A callable class for an actor pool: one instance an actor."""

    def __init__(self, offset):
        self.offset = offset

    def __call__(self, batch):
        return {"data": batch["data"] + self.offset,
                "sq": batch["sq"]}


def _everyone(value):
    """Every rank's ``value``, in rank order, over the trainer's group
    (just this rank's where no group was formed: the local backend)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def sharded_batches_loop(config):
    """Each rank reads every global batch of ``config["ds"]`` through
    ``iter_device_batches`` with a ``NamedSharding`` of each spec in
    ``config["specs"]`` over ``build_mesh(MeshConfig(dp=N))`` on the CPU,
    and reports every rank's (mesh coordinate, local pieces, global
    shape)."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding
    from ray_tpu_torch.train import session

    mesh = build_mesh(MeshConfig(dp=session.get_world_size()), device="cpu")
    pieces = {}
    for name, spec in config["specs"].items():
        out = []
        for b in config["ds"].iter_device_batches(
                batch_size=config["batch"], device="cpu",
                sharding=NamedSharding(mesh, tuple(spec))):
            x = b["data"]
            assert isinstance(x, DTensor), type(x)
            out.append((list(x.shape), x.to_local().numpy().tolist()))
        pieces[name] = out
    session.report({"ranks": _everyone({
        "rank": session.get_world_rank(), "coord": mesh.get_coordinate(),
        "pieces": pieces})})


TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64,
            remat="dots", ce_vocab_chunks=4, fused_norm=True,
            scan_layers=False)


def gpt2_ingest_loop(config):
    """A tiny GPT-2 (fp32) from ``config["params"]`` (numpy), one step a
    batch of the rank's ``"train"`` shard through ``iter_device_batches``;
    reports every rank's losses and the tokens it read."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    cfg = gpt2.GPT2Config(**TINY, dtype=torch.float32)
    dev = session.get_device()
    state = make_init_fn(lambda g: params_from_numpy(config["params"], dev))(
        torch.Generator())
    step = make_train_step(lambda p, b: gpt2.gpt2_loss(p, b, cfg))
    losses, tokens = [], []
    for batch in session.get_dataset_shard("train").iter_device_batches(
            batch_size=config["rows"], device=dev):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        tokens.append(np.asarray(batch["tokens"]).tolist())
    session.report({"ranks": _everyone({"rank": session.get_world_rank(),
                                        "losses": losses,
                                        "tokens": tokens})})
