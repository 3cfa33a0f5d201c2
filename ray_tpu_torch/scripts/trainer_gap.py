"""Where the trainer's ms/step goes beyond the bare step's: the GPT-2 small
flash step (``FUSED_FLAGS``, batch 8) timed in one process, in turns:

- ``main``: ``measure_gpt2``'s loop on the calling thread;
- ``thread``: the same loop on a fresh thread, as a worker actor runs it;
- ``polled``: on a fresh thread while this thread polls an empty
  ``util/queue.Queue`` and ``wait``s on a pending ref, as the trainer's
  ``_consume_results`` does (one actor call every 5 ms);
- ``trainer``: ``measure_trainer_gpt2`` (the loop through
  ``CudaTrainer(...).fit()``: ``timed_step``'s sync, the reports, a copy
  of the state every second step, and the polling).

Each loop runs ``--warmup`` steps, then ``--steps`` steps with a device
sync after each (as ``timed_step`` does) and reports their mean ms. Run on
a GPU from the repository root::

    python -m ray_tpu_torch.scripts.trainer_gap [--rounds 2] [--out FILE]

It prints one JSON object: the card's name, every round's ms per mode and
the medians.
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time

import torch


def _step_ms(cfg, batch: int, warmup: int, steps: int, device) -> float:
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    state = make_init_fn(lambda g: gpt2_init(g, cfg, device=device))(
        torch.Generator(device=device).manual_seed(0))
    tokens = torch.randint(
        0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg))
    data = {"tokens": tokens}
    for _ in range(warmup):
        state, _ = step_fn(state, data)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step_fn(state, data)
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / steps * 1e3


def _on_thread(fn, poll: bool) -> float:
    """``fn()`` on a fresh thread; with ``poll`` this thread polls an empty
    results queue meanwhile, as ``DataParallelTrainer._consume_results``."""
    import ray_tpu_torch
    from ray_tpu_torch.util.queue import Empty, Queue

    out = {}
    worker = threading.Thread(target=lambda: out.setdefault("ms", fn()))
    worker.start()
    if poll:
        queue = Queue()
        pending = [ray_tpu_torch.put(None)]
        while worker.is_alive():
            ray_tpu_torch.wait(pending, num_returns=1, timeout=0.0)
            try:
                queue.get(timeout=1.0)
            except Empty:
                pass
        queue.shutdown()
    worker.join()
    return out["ms"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import ray_tpu_torch
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.scripts.measure import FUSED_FLAGS, measure_trainer_gpt2

    device = torch.device("cuda")
    cfg = GPT2Config(**FUSED_FLAGS)
    ray_tpu_torch.init()

    def bare():
        return _step_ms(cfg, 8, args.warmup, args.steps, device)

    modes = {
        "main": bare,
        "thread": lambda: _on_thread(bare, poll=False),
        "polled": lambda: _on_thread(bare, poll=True),
        "trainer": lambda: measure_trainer_gpt2(
            cfg, 8, steps=args.warmup + args.steps, warmup=args.warmup,
            device=device)["ms_step"],
    }
    rounds = []
    for _ in range(args.rounds):
        rounds.append({name: fn() for name, fn in modes.items()})
    ray_tpu_torch.shutdown()
    report = {"device": torch.cuda.get_device_name(device), "rounds": rounds,
              "median_ms": {name: statistics.median(r[name] for r in rounds)
                            for name in modes}}
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
