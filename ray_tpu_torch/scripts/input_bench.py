"""Input-pipeline / training-goodput harness with client/server cross-check
(port of ``ray_tpu/scripts/input_bench.py``).

Drives the training ingest path -- dataset -> ``iter_batches`` /
``iter_device_batches`` -> train-step loop -- and REQUIRES the metrics
plane to agree with an independent client-side measurement (the telemetry
itself is under test, not just the workload):

* **pipeline**: a consumer loop with a known per-batch cost measures its
  own stall fraction (time starved in ``next()`` over the loop's wall);
  the bench then derives the same number from the
  ``ray_tpu_data_iter_seconds`` histograms and requires exact batch
  counts and agreement within 0.10 -- disagreement exits non-zero. The
  loop reads ``iter_device_batches`` on ``cuda`` (raising without CUDA)
  unless ``--device`` names another device (``--device cpu`` for a host
  run), and every batch's copy must count a ``transfer`` sample. The
  reference's host-only loop over ``iter_batches`` is not ported: the
  train stage reads ``iter_batches``.
* **train**: a ``DataParallelTrainer`` run whose per-step phase
  histograms (``ray_tpu_train_step_phase_seconds``) must count exactly
  ``workers x steps`` steps, with data_wait / checkpoint phases observed.
* **goodput under drain** (``--drain``) needs the cluster's graceful
  drain, which the port does not have (ROADMAP A4c): it raises
  ``NotImplementedError``.

The result is one JSON document on stdout (``--out`` also writes it, under
``input_pipeline``, into a JSON file); the numbers name the device they
ran on. The reference's evidence log (``bench_log``) is not ported.

Run: python -m ray_tpu_torch.scripts.input_bench [--device cpu]
     [--cluster] [--blocks 8] [--batch-size 64] [--out FILE]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time


def _parsed():
    from ray_tpu_torch.util import metrics

    return metrics.parse_prometheus(metrics.prometheus_text())


def _bucket_width_at(dist, value: float) -> float:
    """Width of the histogram bucket of ``dist`` holding ``value`` (the
    resolution a quantile read from the buckets has there)."""
    prev = 0.0
    for le, _cum in dist["buckets"]:
        if le == float("inf"):
            return value
        if value <= le:
            return le - prev
        prev = le
    return value


def _slow_identity(produce_ms: float, batch):
    time.sleep(produce_ms / 1e3)
    return batch


# -- pipeline stage ---------------------------------------------------------


def run_pipeline(n_blocks: int = 8, rows_per_block: int = 256,
                 batch_size: int = 64, consume_ms: float = 3.0,
                 produce_ms: float = 1.0, device=None) -> dict:
    """Dataset -> ``iter_device_batches(device=device)`` consumer loop;
    cross-check the stall fraction. ``device``: ``cuda`` when None
    (raises without CUDA). Requires an initialized runtime."""
    import numpy as np

    import torch

    from ray_tpu_torch import data
    from ray_tpu_torch._device import device_name, resolve_device
    # By its module's name (under ``-m`` this file runs as __main__, which
    # a cluster worker cannot import).
    from ray_tpu_torch.scripts.input_bench import _slow_identity
    from ray_tpu_torch.util import goodput, metrics

    dev = resolve_device(device)
    before = _parsed()
    n_rows = n_blocks * rows_per_block
    ds = data.from_numpy(
        np.arange(n_rows * 4, dtype=np.float32).reshape(n_rows, 4),
        parallelism=n_blocks,
    ).map_batches(functools.partial(_slow_identity, produce_ms),
                  batch_size=rows_per_block)
    # Execute the plan BEFORE the timed loop: stage execution is its own
    # instrument (ray_tpu_data_stage_seconds); the stall fraction is about
    # the steady-state consumer loop.
    ds.materialize()

    # Warm the device BEFORE the timed loop: the first copy pays the
    # CUDA context's start, which is not an input-pipeline stall.
    torch.zeros(1, device=dev).cpu()

    # Client-side measurement: wall time inside next() (starved) vs the
    # consumer's own time -- measured OUTSIDE the dataset code, an
    # independent view of the loop the iterator instruments.
    waits: list = []
    n_batches = 0
    t_loop0 = time.perf_counter()
    it = iter(ds.iter_device_batches(batch_size=batch_size, drop_last=True,
                                     device=dev))
    while True:
        t0 = time.perf_counter()
        try:
            next(it)
        except StopIteration:
            waits.append(time.perf_counter() - t0)  # final starved probe
            break
        waits.append(time.perf_counter() - t0)
        n_batches += 1
        time.sleep(consume_ms / 1e3)  # the "train step"
    loop_wall = time.perf_counter() - t_loop0
    client_wait = sum(waits)
    client_stall = client_wait / loop_wall if loop_wall > 0 else 0.0

    delta = metrics.diff_parsed(before, _parsed())

    def dist(phase):
        return metrics.histogram_dist(delta, "ray_tpu_data_iter_seconds",
                                      phase=phase)

    wait_d, user_d, xfer_d = dist("wait"), dist("user"), dist("transfer")
    occ_d = metrics.histogram_dist(delta, "ray_tpu_data_prefetch_occupancy")
    stage_names = sorted(set(metrics.sum_counter(
        delta, "ray_tpu_data_stage_seconds_count", "stage")))
    server_stall = goodput.stall_fraction_from(delta)

    # Quantile agreement: the per-batch wait p50 seen by the client must
    # sit within the histogram's bucket resolution of the server's.
    client_p50_ms = (metrics.percentile(sorted(waits), 0.5) * 1e3
                     if waits else None)
    server_p50 = metrics.quantile_from_buckets(wait_d, 0.50)
    server_p50_ms = server_p50 * 1e3 if server_p50 is not None else None
    p50_within = False
    if client_p50_ms is not None and server_p50_ms is not None:
        tol_ms = max(_bucket_width_at(wait_d, client_p50_ms / 1e3) * 1e3,
                     0.35 * client_p50_ms, 2.0)
        p50_within = abs(client_p50_ms - server_p50_ms) <= tol_ms

    counts = {
        "wait": int(wait_d["count"]) if wait_d else 0,
        "user": int(user_d["count"]) if user_d else 0,
        "transfer": int(xfer_d["count"]) if xfer_d else 0,
        "occupancy": int(occ_d["count"]) if occ_d else 0,
    }
    agreement = {
        # The client's extra wait sample is the final next() that raised
        # StopIteration; the iterator records waits for yielded batches
        # only, so both count exactly n_batches.
        "wait_count_exact": counts["wait"] == n_batches,
        "user_count_exact": counts["user"] == n_batches,
        "occupancy_sampled": counts["occupancy"] == n_batches,
        "transfer_count_exact": counts["transfer"] == n_batches,
        "stall_within_tol": (server_stall is not None
                             and abs(client_stall - server_stall) <= 0.10),
        "server_not_exceeding": (wait_d is not None
                                 and wait_d["sum"] <= client_wait * 1.1 + 0.05),
        "p50_within_tol": p50_within,
        "stage_recorded": any("map_batches" in s for s in stage_names),
    }
    agreement["ok"] = all(agreement.values())
    return {
        "n_batches": n_batches,
        "batch_size": batch_size,
        "n_blocks": n_blocks,
        "device": device_name(dev),
        "client": {
            "stall_fraction": client_stall,
            "wait_s": client_wait,
            "loop_wall_s": loop_wall,
            "wait_p50_ms": client_p50_ms,
        },
        "server": {
            "stall_fraction": server_stall,
            "wait_s": wait_d["sum"] if wait_d else None,
            "transfer_s": xfer_d["sum"] if xfer_d else None,
            "wait_p50_ms": server_p50_ms,
            "counts": counts,
        },
        "stages_recorded": stage_names,
        "agreement": agreement,
    }


# -- train stage ------------------------------------------------------------


def bench_train_loop(config: dict) -> None:
    """``run_train``'s loop, one rank: a batch of the rank's shard, a
    ``step_ms`` sleep standing in for the step, a report (with a
    checkpoint on rank 0) per step. At the top level of the module: it
    reaches a cluster's workers by reference."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint

    shard = session.get_dataset_shard("train")
    it = iter(shard.iter_batches(batch_size=16)) if shard is not None \
        else None
    for i in range(config["steps"]):
        if it is not None:
            try:
                next(it)
            except StopIteration:
                it = None
        time.sleep(config["step_ms"] / 1e3)
        ckpt = None
        if session.get_world_rank() == 0:
            ckpt = Checkpoint.from_dict({"step": i})
        session.report({"step": i, "loss": 1.0 / (i + 1)}, checkpoint=ckpt)


def run_train(steps: int = 6, workers: int = 2,
              step_ms: float = 5.0) -> dict:
    """A trainer run; the per-step phase histograms must count exactly
    workers x steps (read from this process's registry: the local
    backend's workers are its threads)."""
    import numpy as np

    from ray_tpu_torch import data
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import DataParallelTrainer
    from ray_tpu_torch.util import metrics

    before = _parsed()
    ds = data.from_numpy(
        np.arange(workers * steps * 32, dtype=np.float32).reshape(-1, 1),
        parallelism=workers * 2)
    result = DataParallelTrainer(
        bench_train_loop,
        train_loop_config={"steps": steps, "step_ms": step_ms},
        scaling_config=ScalingConfig(num_workers=workers),
        datasets={"train": ds},
    ).fit()
    if result.error is not None:
        raise RuntimeError(f"train stage failed: {result.error!r}")
    delta = metrics.diff_parsed(before, _parsed())
    expected = workers * steps
    phase_counts = {}
    for phase in ("data_wait", "step", "report", "checkpoint_save",
                  "checkpoint_restore"):
        d = metrics.histogram_dist(
            delta, "ray_tpu_train_step_phase_seconds", trial="train",
            phase=phase)
        if d:
            phase_counts[phase] = int(d["count"])
    reports = sum(metrics.sum_counter(
        delta, "ray_tpu_train_reports_total", "trial",
        trial="train").values())
    agreement = {
        "step_count_exact": phase_counts.get("step") == expected,
        "reports_exact": int(reports) == expected,
        # Every step consumed the shard iterator -> data_wait samples;
        # rank 0 attached a checkpoint per step.
        "data_wait_observed": phase_counts.get("data_wait", 0) > 0,
        "checkpoint_save_counted":
            phase_counts.get("checkpoint_save") == steps,
    }
    agreement["ok"] = all(agreement.values())
    return {
        "workers": workers,
        "steps": steps,
        "phase_counts": phase_counts,
        "phases_observed": sorted(phase_counts),
        "reports": int(reports),
        "client_reports": len(result.metrics_history),
        "goodput": result.goodput,
        "agreement": agreement,
    }


def run_goodput_drain(*_args, **_kwargs) -> dict:
    """The reference drains a cluster node under a checkpointing trial;
    the port's cluster has no graceful drain yet."""
    raise NotImplementedError(
        "goodput under drain needs the cluster's graceful drain "
        "(ROADMAP A4c)")


# -- driver -----------------------------------------------------------------


def run(blocks: int = 8, batch_size: int = 64, device=None,
        drain: bool = False, steps: int = 6, workers: int = 2,
        cluster: bool = False) -> dict:
    """The pipeline stage (on ``device``: ``cuda`` when None, raising
    without CUDA) and the train stage on a fresh runtime: the local backend, or with ``cluster`` a
    one-node ``Cluster`` (the metrics then read the driver's registry:
    the pipeline's iterator runs here, the trainer's ranks do not, so
    the train stage runs on the local backend either way)."""
    import ray_tpu_torch

    from ray_tpu_torch._device import resolve_device

    if drain:
        run_goodput_drain()
    device = resolve_device(device)  # before any runtime starts
    ray_tpu_torch.shutdown()
    cluster_obj = None
    if cluster:
        from ray_tpu_torch.cluster import Cluster

        cluster_obj = Cluster()
        cluster_obj.add_node(num_cpus=8, num_gpus=0)
        cluster_obj.wait_for_nodes()
        ray_tpu_torch.init(address=cluster_obj.address)
    else:
        ray_tpu_torch.init(num_cpus=8)
    try:
        pipeline = run_pipeline(n_blocks=blocks, batch_size=batch_size,
                                device=device)
    finally:
        ray_tpu_torch.shutdown()
        if cluster_obj is not None:
            cluster_obj.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    try:
        train_res = run_train(steps=steps, workers=workers)
    finally:
        ray_tpu_torch.shutdown()
    result = {
        "backend": "cluster" if cluster else "local",
        "pipeline": pipeline,
        "train": train_res,
    }
    result["agreement"] = {
        "pipeline_ok": pipeline["agreement"]["ok"],
        "train_ok": train_res["agreement"]["ok"],
    }
    result["agreement"]["ok"] = all(result["agreement"].values())
    return result


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Input-pipeline / training-goodput harness with "
                    "client/server stall-fraction cross-check")
    ap.add_argument("--out", default=None,
                    help="write the result under 'input_pipeline' into this "
                         "JSON file (other sections kept)")
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the device iter_device_batches copies to (cuda "
                         "when not given, raising without CUDA; cpu for a "
                         "host run)")
    ap.add_argument("--drain", action="store_true",
                    help="the goodput-under-drain probe (needs ROADMAP A4c; "
                         "raises NotImplementedError)")
    ap.add_argument("--cluster", action="store_true",
                    help="run the pipeline on a one-node port Cluster")
    args = ap.parse_args()

    res = run(blocks=args.blocks, batch_size=args.batch_size,
              device=args.device, drain=args.drain, steps=args.steps,
              workers=args.workers, cluster=args.cluster)
    if args.out:
        payload = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                try:
                    payload = json.load(f)
                except ValueError:
                    payload = {}
        payload["input_pipeline"] = res
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
    print(json.dumps(res, indent=1, default=str))
    if not res["agreement"]["ok"]:
        print("input_bench: CLIENT/SERVER DISAGREE -- the goodput metrics "
              "are wrong; see 'agreement'", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
