"""1F1B vs GPipe pipeline microbenchmark (port of
``ray_tpu/scripts/pipeline_bench.py``).

Times ``parallel/pipeline.py:pipeline_value_and_grad`` under both
schedules at the JAX benchmark's sizes: d_model 128, seq 64, pp 2 and 4,
``n_micro = 4 * pp`` microbatches of 2, each stage ``x + gelu(x @ w1) @
w2`` (w1 [128, 512], w2 [512, 128], normal(0.02) from seed 0), an MSE
loss to a target from seed 2. One rank a stage over an NCCL group, one
card a rank (cuda:0..pp-1); a pp with more stages than cards is skipped,
with a line saying so. ``--device cpu`` runs the ranks over gloo.

Keys ``pp{pp}_m{n_micro}_{style}``: ``step_ms`` (one training pass, the
slowest rank's mean over 10 after one warmup), ``ticks`` (the timetable's
length), ``bubble_frac`` (1 - n_micro / ticks), and
``peak_memory_mb_by_rank`` (``torch.cuda.max_memory_allocated`` a rank,
where the JAX script reads XLA's compiled temp buffers; None on the
CPU).

    python -m ray_tpu_torch.scripts.pipeline_bench [--device cpu]
        [--out results.json]

Prints one JSON object; ``--out`` (no default) writes it to a file of
its own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

D_MODEL, SEQ, MICRO = 128, 64, 2
PPS = (2, 4)
STYLES = ("1f1b", "gpipe")
STEPS = 10


def _stage(p, x):
    import torch.nn.functional as F

    return x + F.gelu(x @ p["w1"]) @ p["w2"]


def _mse(o, y):
    return ((o - y) ** 2).mean()


def run_rank(rank: int, pp: int, address: str, device: str,
             result: str) -> None:
    """One stage of the pp-stage pipeline; writes this rank's results."""
    import torch

    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.sharding import NamedSharding, shard_pytree
    from ray_tpu_torch.scripts.measure import measure_pipeline

    if device == "cpu":
        torch.set_num_threads(1)
    distributed.initialize("pipeline-bench", rank, pp, device=device,
                           coordinator_address=address)
    try:
        mesh = build_mesh(MeshConfig(pp=pp, fsdp=1), device=device)
        dev = torch.device(f"cuda:{torch.cuda.current_device()}"
                           if device == "cuda" else "cpu")
        n_micro = 4 * pp
        gen = torch.Generator(device=dev)
        params = {"w1": torch.randn((pp, D_MODEL, 4 * D_MODEL), device=dev,
                                    generator=gen.manual_seed(0)) * 0.02,
                  "w2": torch.randn((pp, 4 * D_MODEL, D_MODEL), device=dev,
                                    generator=gen) * 0.02}
        spec = NamedSharding(mesh, ("pp", None, None))
        params = shard_pytree(params, {"w1": spec, "w2": spec}, mesh)
        shape = (MICRO * n_micro, SEQ, D_MODEL)
        x = torch.randn(shape, device=dev, generator=gen.manual_seed(1))
        y = torch.randn(shape, device=dev, generator=gen.manual_seed(2))
        out = {}
        for style in STYLES:
            r = measure_pipeline(params, x, y, mesh, stage_fn=_stage,
                                 loss_fn=_mse, n_micro=n_micro, style=style,
                                 steps=STEPS, warmup=1, device=dev)
            out[f"pp{pp}_m{n_micro}_{style}"] = {
                k: r[k] for k in ("ms", "ticks", "bubble_frac", "loss",
                                  "peak_memory_bytes")}
        Path(result).with_suffix(f".rank{rank}.json").write_text(
            json.dumps(out))
    finally:
        distributed.shutdown()


def run_all(device: str = "cuda", timeout: float = 600.0) -> dict:
    import torch

    from ray_tpu_torch.parallel.distributed import free_port

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("pipeline_bench: needs a CUDA device (or "
                         "--device cpu)")
    cards = torch.cuda.device_count() if device == "cuda" else None
    results: dict = {}
    for pp in PPS:
        if cards is not None and cards < pp:
            print(f"pipeline_bench: pp={pp} not run: {cards} CUDA "
                  f"device(s), needs {pp}", file=sys.stderr, flush=True)
            continue
        with tempfile.TemporaryDirectory() as tmp:
            result = str(Path(tmp) / "pp.json")
            address = f"127.0.0.1:{free_port()}"
            procs = [subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.scripts.pipeline_bench",
                 "--rank", str(r), "--pp", str(pp), "--address", address,
                 "--device", device, "--result", result])
                for r in range(pp)]
            try:
                rcs = [p.wait(timeout=timeout) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            if rcs != [0] * pp:
                raise RuntimeError(f"pipeline_bench pp={pp}: ranks exited "
                                   f"{rcs}")
            ranks = [json.loads(Path(result).with_suffix(
                f".rank{r}.json").read_text()) for r in range(pp)]
        for key, r0 in ranks[0].items():
            mem = [r[key]["peak_memory_bytes"] for r in ranks]
            results[key] = {
                "step_ms": max(r[key]["ms"] for r in ranks),
                "ticks": r0["ticks"],
                "bubble_frac": round(r0["bubble_frac"], 4),
                "loss": r0["loss"],
                "peak_memory_mb_by_rank": (None if None in mem else
                                           [m / 2**20 for m in mem])}
            print(f"{key}: {results[key]}", file=sys.stderr, flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pp", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--result", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        run_rank(args.rank, args.pp, args.address, args.device, args.result)
        return
    results = run_all(args.device)
    if args.out:
        if Path(args.out).name == "MICROBENCH.json":
            raise SystemExit("pipeline_bench: --out names a file of its own, "
                             "not MICROBENCH.json")
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps(results))


if __name__ == "__main__":
    main()
