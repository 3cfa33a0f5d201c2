"""Trainables the port's Tune tests run on a cluster, and on the card.

A cluster sends a trainable to its trial's worker by reference (module and
name, ``ray_tpu_torch/core/serialization.py``), so they live at the top
level of this importable module: where the JAX package's tests pickle
theirs by value with cloudpickle (``tests/test_tune_pg.py:20``), the
port's tests import them from here, with the same checks.
"""

import os
import time

from ray_tpu_torch import tune
from ray_tpu_torch.train import session


def score_trainable(config):
    """One report: score = 10 x, with this attempt's wall-clock span and
    process, so a test can see two trials one after the other."""
    start = time.time()
    session.report({"score": config["x"] * 10, "start": start,
                    "end": time.time(), "pid": os.getpid()})


# A module-level ``with_resources`` object asking for a gang of two
# bundles, [{CPU: 2}, {CPU: 1}]: it reaches a worker by reference to
# ``score_trainable``.
score_in_a_gang = tune.with_resources(
    score_trainable,
    {"bundles": [{"CPU": 2}, {"CPU": 1}], "strategy": "PACK"})

# The losses of ``tests/test_torch_trainer.py``'s tiny GPT-2 in fp32 on the
# CPU, batch 8: ``scripts/measure.py``'s init (seed 0), batch (seed 1) and
# three AdamW steps at lr 3e-4, as ``measure_trainer_gpt2(cfg, 8, steps=3,
# device="cpu", ckpt_every=0)`` gives them.
# ``tests/test_torch_tune_runner.py`` holds that direct run to these
# numbers, and ``tests/test_torch_tune_cluster.py`` a trial on the cluster.
TINY_GPT2_LOSSES = [5.571771621704102, 5.524731159210205, 5.479679107666016]


def device_trial(config):
    """Reports the session's device and the device of a product computed
    on it (``tests/test_torch_package.py``'s GPU trial)."""
    import torch

    dev = session.get_device()
    x = torch.ones(4, 4, device=dev) * config["x"]
    y = x @ x
    session.report({"device": str(dev), "result_device": str(y.device),
                    "value": float(y[0, 0])})


def cpu_probe_trial(config):
    """Records that it ran (a trial that must never run reports here)."""
    session.report({"ran": True, "device": str(session.get_device())})
