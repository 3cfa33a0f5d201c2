"""ray_tpu_torch.parallel (mesh and sharding rules) against ray_tpu.parallel
on the CPU, in one process.

The port's meshes are real ``DeviceMesh``es over a ``fake`` process group
(``torch.testing._internal.distributed.fake_pg``: one process acts as one
rank of a world of 8, and no collective runs); the JAX side runs over the
suite's 8 virtual CPU devices. Checked exactly: ``MeshConfig.axis_sizes``
and its errors, ``logical_spec`` for every parameter of GPT-2 and Llama
under the default and a custom rules table, the region every rank holds
under the port's DTensor placements against JAX's ``devices_indices_map``
of the same spec, the rank layouts of ``build_mesh`` and
``build_hybrid_mesh`` against ``np.vectorize(lambda d: d.id)`` of JAX's
mesh, and the errors the port raises where JAX has no counterpart (a
mesh axis the train step cannot run above 1, several axes on one dim out
of mesh order, a DTensor at a kernel wrapper).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel import mesh as jmesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.ops import fused_norm as tfn
from ray_tpu_torch.parallel import distributed as tdistributed
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsharding
from ray_tpu_torch.train.checkpoint import _shard_bounds
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of ``n``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _raises_same(jfn, tfn_):
    """Both raise ValueError with the same message, or return equal."""
    try:
        want = jfn()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfn_()
        assert str(got.value) == str(e)
        return
    assert tfn_() == want


AXIS_CASES = [
    (dict(), 8), (dict(), 1), (dict(dp=2), 8), (dict(dp=2, fsdp=2), 4),
    (dict(pp=2, dp=2, fsdp=2), 8), (dict(tp=2, sp=2), 8),
    (dict(fsdp=1, ep=-1), 4), (dict(dp=3), 8), (dict(dp=-1), 8),
    (dict(dp=2, fsdp=2), 8), (dict(fsdp=4, tp=4), 8),
]


@pytest.mark.parametrize("kw,n", AXIS_CASES,
                         ids=[f"{kw}-{n}" for kw, n in AXIS_CASES])
def test_axis_sizes_match_jax(kw, n):
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER
    _raises_same(lambda: jmesh.MeshConfig(**kw).axis_sizes(n),
                 lambda: tmesh.MeshConfig(**kw).axis_sizes(n))


def test_defaults_match_jax():
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES
    assert tmesh.auto_mesh_config() == tmesh.MeshConfig()
    assert tmesh.auto_mesh_config(4).fsdp == jmesh.auto_mesh_config(4).fsdp


CUSTOM_RULES = {
    "batch": ("dp", "fsdp"), "seq": ("sp",), "vocab": ("fsdp", "tp"),
    "embed": ("tp",), "mlp": ("fsdp",), "heads": ("tp",),
    "qkv": ("dp", "fsdp"), "kv_seq": ("sp",), "layers": None,
    "expert": ("ep",), None: None,
}
MODELS = {
    "gpt2": (lambda: jgpt2.gpt2_param_axes(jgpt2.GPT2Config.tiny()),
             lambda: tgpt2.gpt2_param_axes(tgpt2.GPT2Config.tiny())),
    "llama": (lambda: jllama.llama_param_axes(jllama.LlamaConfig.tiny()),
              lambda: tllama.llama_param_axes(tllama.LlamaConfig.tiny())),
}
# Activation axes the models name (``with_logical_constraint`` hints).
ACTIVATIONS = [("batch", "seq", "embed"), ("layers", "embed", "qkv"),
               ("batch", "seq", "heads", None), ("batch", "seq", "vocab")]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("rules", ["default", "custom"])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_logical_spec_matches_jax(model, rules):
    table = None if rules == "default" else CUSTOM_RULES
    jaxes, taxes = (f() for f in MODELS[model])
    assert taxes == jaxes
    for path, axes in list(_leaves(taxes)) + [((), a) for a in ACTIVATIONS]:
        want = tuple(jsharding.logical_spec(axes, table))
        assert tsharding.logical_spec(axes, table) == want, (path, axes)


def test_logical_spec_examples():
    assert tsharding.logical_spec(("batch", "seq", "embed")) == (
        ("dp", "fsdp"), "sp", None)
    assert tsharding.logical_spec(("layers", "embed", "qkv")) == (
        "pp", "fsdp", "tp")


def _tiny_shapes(model):
    if model == "gpt2":
        p = tgpt2.gpt2_init(torch.Generator(), tgpt2.GPT2Config.tiny(),
                            device="cpu")
        axes = tgpt2.gpt2_param_axes(tgpt2.GPT2Config.tiny())
    else:
        p = tllama.llama_init(torch.Generator(), tllama.LlamaConfig.tiny(),
                              device="cpu")
        axes = tllama.llama_param_axes(tllama.LlamaConfig.tiny())
    shapes = dict((path, tuple(t.shape)) for path, t in _leaves(p))
    out = [(path, shapes[path], a) for path, a in _leaves(axes)]
    out.append((("activation",), (8, 64, 64), ("batch", "seq", "embed")))
    return out


LAYOUT_MESHES = [dict(fsdp=8), dict(dp=2, fsdp=4), dict(dp=2, fsdp=2, tp=2),
                 dict(pp=2, fsdp=2, sp=2)]


@pytest.mark.parametrize("mesh_kw", LAYOUT_MESHES,
                         ids=[str(m) for m in LAYOUT_MESHES])
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_placements_give_jax_layout(model, mesh_kw):
    """Every rank's block of every parameter (and of a batch activation)
    under the port's placements is the block JAX's NamedSharding of the
    same spec gives the device at the same mesh coordinate."""
    jm = jmesh.build_mesh(jmesh.MeshConfig(**mesh_kw))
    jids = np.vectorize(lambda d: d.id)(jm.devices)
    with fake_world(8):
        tm = tmesh.build_mesh(tmesh.MeshConfig(**mesh_kw), device="cpu")
        assert tm.mesh_dim_names == tmesh.AXIS_ORDER
        np.testing.assert_array_equal(tm.mesh.numpy(), jids)
        for path, shape, axes in _tiny_shapes(model):
            spec = tsharding.logical_spec(axes)
            ts = tsharding.logical_sharding(tm, axes)
            assert ts.spec == spec
            jmap = JNamedSharding(jm, PartitionSpec(*spec)) \
                .devices_indices_map(shape)
            by_id = {d.id: idx for d, idx in jmap.items()}
            for coord in np.ndindex(jids.shape):
                got = _shard_bounds(shape, ts.placements, tm.shape, coord)
                want = tuple(zip(*[(s.start or 0, n if s.stop is None
                                    else s.stop)
                                   for s, n in zip(by_id[jids[coord]],
                                                   shape)]))
                if not shape:
                    want = ((), ())
                assert got == want, (path, coord, ts.placements)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    r = Replicate()
    assert tsharding.spec_placements((("dp", "fsdp"), "sp", None)) == (
        r, Shard(0), Shard(0), r, Shard(1), r)
    assert tsharding.spec_placements(("pp", "fsdp", "tp")) == (
        Shard(0), r, Shard(1), r, r, Shard(2))
    assert tsharding.spec_placements((None,)) == (r,) * 6


@pytest.mark.parametrize("spec,match", [
    ((("fsdp", "dp"),), "out of mesh order"),
    (("fsdp", "fsdp"), "used twice"),
    (("xy",), "no mesh axis"),
])
def test_bad_specs_raise(spec, match):
    """Several axes on one dim out of mesh order have no DTensor layout;
    the port raises instead of giving another layout."""
    with pytest.raises(ValueError, match=match):
        tsharding.spec_placements(spec)


def test_rules_out_of_mesh_order_raise():
    rules = dict(tsharding.DEFAULT_RULES, batch=("fsdp", "dp"))
    with fake_world(8):
        tm = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=4), device="cpu")
        with pytest.raises(ValueError, match="out of mesh order"):
            tsharding.logical_sharding(tm, ("batch", "embed"), rules)


HYBRID_CASES = [
    dict(per_slice=dict(fsdp=2), dcn_dp=2, dcn_pp=2),
    dict(dcn_dp=2),
    dict(dcn_pp=2),
    dict(per_slice=dict(pp=2, fsdp=-1), dcn_dp=2),
    dict(per_slice=dict(dp=2, fsdp=-1), dcn_dp=2, reverse=True),
    dict(dcn_dp=3),
    dict(per_slice=dict(fsdp=3), dcn_dp=2),
]


@pytest.mark.parametrize("case", HYBRID_CASES,
                         ids=[str(c) for c in HYBRID_CASES])
def test_hybrid_mesh_layout_matches_jax(case):
    case = dict(case)
    reverse = case.pop("reverse", False)
    per = case.pop("per_slice", None)
    ranks = list(range(8))[::-1] if reverse else list(range(8))
    jdevs = [jax.devices()[r] for r in ranks]

    def jax_layout():
        m = jmesh.build_hybrid_mesh(
            jmesh.MeshConfig(**per) if per else None, devices=jdevs, **case)
        return np.vectorize(lambda d: d.id)(m.devices).tolist()

    def port_layout():
        m = tmesh.build_hybrid_mesh(
            tmesh.MeshConfig(**per) if per else None, devices=ranks,
            device="cpu", **case)
        assert m.mesh_dim_names == tmesh.AXIS_ORDER
        return m.mesh.tolist()

    with fake_world(8):
        _raises_same(jax_layout, port_layout)


def test_single_device_mesh():
    with fake_world(1):
        m = tmesh.single_device_mesh(device="cpu")
        assert m.shape == (1,) * 6 and m.mesh.tolist() == [[[[[[0]]]]]]


def _tiny_loss(p, b):
    return tgpt2.gpt2_loss(p, b, tgpt2.GPT2Config.tiny())


@pytest.mark.parametrize("axis,item", [("tp", "A10b"), ("sp", "A10"),
                                       ("pp", "A13"), ("ep", "A12")])
def test_unported_axes_raise_in_the_train_step(axis, item):
    """tp/sp/pp above 1 need the model to compute sharded: the step and
    the init raise rather than store the state sharded over them. ep
    (A12) is ported with the MoE model: the step and the init build on a
    mesh with ep=2 (tests/test_torch_moe_ep.py runs them)."""
    with fake_world(2):
        m = tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, **{axis: 2}),
                             device="cpu")
        sh = tgpt2.gpt2_shardings(tgpt2.GPT2Config.tiny(), m)
        if axis == "ep":
            assert callable(make_train_step(_tiny_loss, sh, m))
            assert callable(make_init_fn(lambda g: None, sh, m))
            return
        with pytest.raises(NotImplementedError, match=f"{axis}=2.*{item}"):
            make_train_step(_tiny_loss, sh, m)
        with pytest.raises(NotImplementedError, match=f"{axis}=2.*{item}"):
            make_init_fn(lambda g: None, sh, m)


def test_mesh_and_shardings_go_together():
    with pytest.raises(ValueError, match="together"):
        make_train_step(_tiny_loss, {"w": None})
    with pytest.raises(ValueError, match="together"):
        make_init_fn(lambda g: None, None, object())


def test_no_group_no_mesh():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        tmesh.build_mesh(device="cpu")


def test_cuda_mesh_and_group_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.build_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdistributed.initialize("g", 0, 1)
    assert not dist.is_initialized()


def test_cuda_mesh_needs_nccl(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with fake_world(1):
        with pytest.raises(RuntimeError, match="nccl"):
            tmesh.build_mesh(tmesh.MeshConfig(fsdp=1), device="cuda")


def test_initialize_needs_an_address_past_one_rank():
    with pytest.raises(ValueError, match="coordinator_address"):
        tdistributed.initialize("g", 1, 2, device="cpu")
    assert not dist.is_initialized()


def test_one_rank_group_without_an_address():
    tdistributed.initialize("solo", 0, 1, device="cpu")
    try:
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        m = tmesh.build_mesh(device="cpu")
        assert m.shape == (1,) * 6
    finally:
        tdistributed.shutdown()
    assert not dist.is_initialized()


def test_with_logical_constraint_returns_x():
    x = torch.ones(2, 3)
    assert tsharding.with_logical_constraint(x, ("batch", "embed")) is x


def test_a_dtensor_never_reaches_a_kernel_wrapper():
    from torch.distributed.tensor import DTensor, Replicate

    with fake_world(1):
        m = tmesh.build_mesh(tmesh.MeshConfig(fsdp=1), device="cpu")
        x = DTensor.from_local(torch.ones(4, 8), m, [Replicate()] * 6,
                               run_check=False)
        with pytest.raises(TypeError, match="plain tensors.*DTensor"):
            tfn.gelu_fwd(x)
        with pytest.raises(TypeError, match="plain tensors"):
            tfn.ln_fwd(x, torch.ones(8), torch.zeros(8))


def test_batch_spec_must_split_evenly():
    """The step keeps this rank's rows of the global batch; rows that do
    not divide over the batch axes raise, as JAX's jit does."""
    from ray_tpu_torch.train.train_step import _local_rows

    with fake_world(4, rank=3):
        m = tmesh.build_mesh(tmesh.MeshConfig(dp=2, fsdp=2), device="cpu")
        x = torch.arange(8 * 3).reshape(8, 3)
        coord = m.get_coordinate()
        got = _local_rows(x, (("dp", "fsdp"),), m, coord)
        torch.testing.assert_close(got, x[6:8])
        got = _local_rows(x, ("fsdp",), m, coord)
        torch.testing.assert_close(got, x[4:8])
        with pytest.raises(ValueError, match="split evenly"):
            _local_rows(x[:6], (("dp", "fsdp"),), m, coord)
    jm = jmesh.build_mesh(jmesh.MeshConfig(dp=2, fsdp=2,
                                           devices=jax.devices()[:4]))
    arr = jax.device_put(jnp.arange(24).reshape(8, 3),
                         JNamedSharding(jm, PartitionSpec(("dp", "fsdp"))))
    shard = [s for s in arr.addressable_shards if s.device.id == 3][0]
    np.testing.assert_array_equal(np.asarray(shard.data), x[6:8].numpy())
