"""ray_tpu_torch.train.session and util/xla_cost against the JAX package's
step-anatomy contract (``tests/test_step_anatomy.py``), on the CPU.

- The anatomy phases partition the step wall exactly, and a plain loop
  records no anatomy, as the reference's session does.
- ``mfu_percent`` does the reference's arithmetic on the port's peak table.
- ``step_cost`` (FlopCounterMode over one call of the step) on the tiny
  GPT-2 and Llama train steps: within 0.25-4x of the analytic count, as
  the reference's test holds XLA's count, and within 10% of the JAX
  package's ``xla_cost.step_cost`` on the same config (``remat="dots"``,
  fp32, batch 8 x 64). XLA counts elementwise ops too; the port counts
  matrix products and attention only.
- The flash path counts what the dense path counts (the custom ops' FLOP
  formulas), and the call leaves the caller's state untouched.
- The per-rank gauges are retracted when the trial ends.

The ``gpu`` case holds the kernel path's count against the plain path's
on the card. It skips without one. The JAX package is imported inside the
one test that needs it, so the file runs on a GPU machine without JAX
(``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_session.py -m gpu``).
"""

import queue
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.train import session
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
from ray_tpu_torch.train.trainer import CudaTrainer
from ray_tpu_torch.util import device_telemetry, goodput, metrics, xla_cost

TINY = {
    "gpt2": dict(vocab_size=256, n_layer=2, n_head=4, d_model=128,
                 seq_len=64),
    "llama": dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                  d_model=128, seq_len=64),
}
PORT = {"gpt2": (tgpt2.GPT2Config, tgpt2.gpt2_init, tgpt2.gpt2_loss,
                 tgpt2.gpt2_flops_per_token),
        "llama": (tllama.LlamaConfig, tllama.llama_init, tllama.llama_loss,
                  tllama.llama_flops_per_token)}


@pytest.fixture(autouse=True, scope="module")
def _runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


@pytest.fixture
def recorded(monkeypatch):
    """Every record_step / record_anatomy call, still recorded."""
    calls = {"step": [], "anat": []}
    orig_step, orig_anat = goodput.record_step, goodput.record_anatomy

    def step(trial, rank, phases):
        calls["step"].append((trial, rank, dict(phases)))
        orig_step(trial, rank, phases)

    def anat(trial, rank, phases, mfu=None):
        calls["anat"].append((trial, rank, dict(phases), mfu))
        orig_anat(trial, rank, phases, mfu=mfu)

    monkeypatch.setattr(goodput, "record_step", step)
    monkeypatch.setattr(goodput, "record_anatomy", anat)
    return calls


def _session(trial):
    session.init_session(
        world_rank=0, world_size=1, local_rank=0, node_rank=0,
        results_queue=queue.Queue(), checkpoint=None,
        dataset_shards=None, trial_info={"trial_id": trial})


def _series(family, trial):
    parsed = metrics.parse_prometheus(metrics.prometheus_text())
    return [dict(lb) for lb in parsed.get(family) or {}
            if dict(lb).get("trial") == trial]


# -- the session: exact partition + MFU export ------------------------------


def test_anatomy_phases_partition_step_wall_exactly(recorded):
    _session("anat-t")
    try:
        session.set_step_cost(1e6)
        for _ in range(3):
            session.add_data_wait(0.002)
            time.sleep(0.002)
            session.timed_step(time.sleep, 0.003)
            session.report({})
    finally:
        session.shutdown_session()
    walls = [p.get("data_wait", 0.0) + p["step"]
             for t, _, p in recorded["step"] if t == "anat-t"]
    anats = [(p, m) for t, _, p, m in recorded["anat"] if t == "anat-t"]
    assert len(anats) == 3 and len(walls) == 3
    for (phases, mfu), wall in zip(anats, walls):
        assert set(phases) == {"data_wait", "host", "compute", "sync"}
        assert sum(phases.values()) == pytest.approx(wall, abs=1e-9)
        assert mfu is not None  # MFU rides the anatomy record
    goodput.retract_trial("anat-t")


def test_plain_train_fn_emits_no_anatomy(recorded):
    _session("plain-t")
    try:
        time.sleep(0.002)
        session.report({})
    finally:
        session.shutdown_session()
    assert [t for t, *_ in recorded["step"]] == ["plain-t"]
    assert not recorded["anat"]  # uninstrumented steps stay classic
    goodput.retract_trial("plain-t")


def test_block_sync_is_a_noop_on_cpu_outputs():
    out = {"loss": torch.ones(()), "parts": [torch.zeros(2), 3]}
    assert session._block_sync(out) is out
    assert session._cuda_devices(out, set()) == set()


def test_mfu_percent_math():
    # 1e12 FLOPs in 1s on a 0.5 TFLOP/s cpu "chip" = 200% (nominal peak).
    assert xla_cost.mfu_percent(
        1e12, 1.0, device_kind="cpu") == pytest.approx(200.0)
    # Scales down with device count, guards degenerate inputs.
    assert xla_cost.mfu_percent(
        1e12, 1.0, device_kind="cpu", n_devices=2) == pytest.approx(100.0)
    assert xla_cost.mfu_percent(0.0, 1.0) == 0.0
    assert xla_cost.mfu_percent(1e12, 0.0) == 0.0


# -- step_cost ---------------------------------------------------------------


def _port_step(model, device="cpu", **over):
    cfg_cls, init, loss, flops = PORT[model]
    cfg = cfg_cls(**{**TINY[model], "remat": "dots",
                     "dtype": torch.float32, **over})
    state = make_init_fn(lambda g: init(g, cfg, device=device))(
        torch.Generator(device=device).manual_seed(0))
    return cfg, state, make_train_step(lambda p, b: loss(p, b, cfg)), flops


def _tokens(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, cfg.seq_len + 1), dtype=np.int32)


@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_step_cost_agrees_with_analytic_and_jax(model):
    cfg, state, step, flops_fn = _port_step(model)
    tokens = _tokens(cfg)
    cost = xla_cost.step_cost(step, state, {"tokens": torch.from_numpy(tokens)})
    assert cost["available"] and cost["device_kind"] == "cpu"
    assert cost["peak_flops"] == 0.5e12
    analytic = flops_fn(cfg) * tokens.shape[0] * cfg.seq_len
    assert 0.25 <= cost["flops"] / analytic <= 4.0

    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.models import llama as jllama
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
    from ray_tpu.train.train_step import make_train_step as jmake_train_step
    from ray_tpu.util import xla_cost as jxla_cost

    jcfg_cls, jinit, jloss, jshard = {
        "gpt2": (jgpt2.GPT2Config, jgpt2.gpt2_init, jgpt2.gpt2_loss,
                 jgpt2.gpt2_shardings),
        "llama": (jllama.LlamaConfig, jllama.llama_init, jllama.llama_loss,
                  jllama.llama_shardings)}[model]
    jcfg = jcfg_cls(**TINY[model], remat="dots", dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(fsdp=-1))
    shardings = jshard(jcfg, mesh)
    jstate = jmake_init_fn(lambda r: jinit(r, jcfg), shardings, mesh)(
        jax.random.key(0))
    jstep = jmake_train_step(lambda p, b: jloss(p, b, jcfg), shardings, mesh)
    jcost = jxla_cost.step_cost(jstep, jstate,
                                {"tokens": jnp.asarray(tokens)})
    assert jcost["available"]
    # cost_analysis() counts one partition's program: 1/N of the batch.
    jflops = jcost["flops"] * jax.device_count()
    assert cost["flops"] == pytest.approx(jflops, rel=0.10)


def test_step_cost_counts_flash_as_dense_and_leaves_state():
    cfg, state, step, _ = _port_step("gpt2", use_flash=True)
    before = [t.clone() for t in tree_leaves(state["params"])]
    batch = {"tokens": torch.from_numpy(_tokens(cfg))}
    flash = xla_cost.step_cost(step, state, batch)
    assert {"ray_tpu_torch.flash_fwd", "ray_tpu_torch.flash_dkv",
            "ray_tpu_torch.flash_dq"} <= set(flash["flops_by_op"])
    # The copies took the in-place update: the caller's state is as it was.
    assert state["step"] == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, tree_leaves(state["params"])))
    dense_cfg, _, dense_step, _ = _port_step("gpt2", use_flash=False)
    dense = xla_cost.step_cost(dense_step, state, batch)
    assert "ray_tpu_torch.flash_fwd" not in dense["flops_by_op"]
    # Only flash_delta's rowsum einsum is the flash path's own.
    assert flash["flops"] == pytest.approx(dense["flops"], rel=1e-3)


def test_step_cost_of_a_call_without_products_is_a_stub():
    cost = xla_cost.step_cost(lambda x: x + 1, torch.ones(3))
    assert cost == {"available": False,
                    "reason": "the call dispatched no op with a FLOP formula"}


def test_device_telemetry_is_a_stub_without_a_cuda_context():
    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process")
    snap = device_telemetry.snapshot()
    assert snap["available"] is False and snap["devices"] == []


# -- gauge lifecycle ---------------------------------------------------------


def test_retract_trial_clears_anatomy_gauges():
    goodput.record_anatomy("rt-t", 0, {"data_wait": 0.01, "host": 0.01,
                                       "compute": 0.05, "sync": 0.0},
                           mfu=33.0)
    goodput.record_step("rt-t", 0, {"step": 0.07})
    assert _series("ray_tpu_step_phase_seconds", "rt-t")
    assert _series("ray_tpu_mfu_percent", "rt-t")
    assert _series("ray_tpu_train_rank_step_seconds", "rt-t")
    goodput.retract_trial("rt-t")
    for fam in ("ray_tpu_step_phase_seconds", "ray_tpu_mfu_percent",
                "ray_tpu_train_rank_step_seconds"):
        assert not _series(fam, "rt-t"), fam


def test_trainer_exports_mfu_while_it_runs_and_retracts_at_the_end():
    seen = []

    def loop(config):
        cfg, state, step, _ = _port_step("gpt2")
        batch = {"tokens": torch.from_numpy(_tokens(cfg))}
        session.set_step_cost(xla_cost.step_cost(step, state, batch))
        for _ in range(2):
            state, _m = session.timed_step(step, state, batch)
            session.report({})
            seen.append(metrics.TRAIN_MFU_PERCENT.get(
                {"node_id": "local", "trial": "train", "rank": "0"}))

    result = CudaTrainer(loop, scaling_config=ScalingConfig(num_workers=1),
                         device="cpu").fit()
    assert result.error is None
    assert len(seen) == 2 and all(m is not None and m > 0 for m in seen)
    for fam in ("ray_tpu_step_phase_seconds", "ray_tpu_mfu_percent",
                "ray_tpu_train_rank_step_seconds"):
        assert not _series(fam, "train"), fam


# -- on a GPU ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernel_path_counts_the_plain_paths_flops_on_gpu(cuda):
    """GPT-2 at d_model 256 (head_dim 64), seq 128, bf16: the kernel path
    (flash, fused norms) counts the plain path's FLOPs within 1%, and the
    count on the card equals the CPU's (the backward, on autograd's
    device thread, is counted)."""
    kw = dict(d_model=256, seq_len=128, dtype=torch.bfloat16)
    counts = {}
    for name, device, over in (
            ("kernel", cuda, dict(use_flash=True, fused_norm=True)),
            ("plain", cuda, dict(use_flash=False, fused_norm=False)),
            ("cpu", "cpu", dict(use_flash=True, fused_norm=True))):
        cfg, state, step, _ = _port_step("gpt2", device=device, **kw, **over)
        tokens = torch.from_numpy(_tokens(cfg)).to(device)
        counts[name] = xla_cost.step_cost(step, state, {"tokens": tokens})
    assert counts["kernel"]["device_kind"] == torch.cuda.get_device_name()
    assert counts["kernel"]["flops"] == pytest.approx(
        counts["plain"]["flops"], rel=0.01)
    assert counts["kernel"]["flops"] == counts["cpu"]["flops"]
    snap = device_telemetry.snapshot()
    assert snap["available"]
    assert snap["devices"][0]["device_kind"] == torch.cuda.get_device_name(0)
