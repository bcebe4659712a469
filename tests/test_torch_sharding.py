"""The port's sharding planner against the reference's, on the CPU.

No process group and no devices: both planners take a planning-only mesh
(``repro.distributed.sharding.abstract_mesh``, a JAX ``AbstractMesh``, which
the port reads through its ``shape`` mapping). For every config of the
registry:

  - each family's ``param_axes(cfg)`` equals the reference's
    ``model.init(None)[1]`` leaf for leaf, by name, and ``cache_axes()``
    the reference's;
  - on the meshes (16, 16), (2, 16, 16), (2, 2, 2) and (4, 2), the port's
    ``plan_tree`` spec of every parameter equals the reference's
    ``PartitionSpec`` under ``TRAIN_RULES`` and ``SERVE_RULES``, and the
    DTensor placements are the ones the spec implies;
  - ``batch_spec`` and ``serve_shardings`` (parameters and the cache of the
    decode cell, with the kv-heads -> sequence fallback) likewise.

Then the cases of ``tests/test_sharding.py``, on the port.
"""
import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

import repro.configs as ref_configs
import repro.distributed.sharding as ref_sh
import repro.serve.engine as ref_serve
import repro_torch.configs as port_configs
import repro_torch.distributed.sharding as port_sh
import repro_torch.serve.engine as port_serve
from repro.models.api import build_model as ref_build
from repro_torch.models.api import build_model as port_build

ARCH_IDS = list(ref_configs.ARCHS)
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}


def _names(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))[0]
    return {".".join(str(k.key) for k in path): v for path, v in flat}


def _spec(ref_named) -> tuple:
    return tuple(ref_named.spec)


def _implied(axes: tuple, spec: tuple) -> tuple:
    where = {}
    for d, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                where[a] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in axes)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_and_cache_axes_equal_the_references(arch_id):
    for which in ("config", "smoke"):
        rcfg = getattr(ref_configs.get_arch(arch_id), which)
        pcfg = getattr(port_configs.get_arch(arch_id), which)
        ref = ref_build(rcfg)
        _, ref_axes = ref.init(None)
        port = port_build(pcfg, device="meta")
        assert port.param_axes(pcfg) == {
            k: tuple(v) for k, v in _names(ref_axes).items()}
        assert tuple(port.cache_axes()) == tuple(ref.cache_axes())
        assert type(port.cache_axes()).__name__ == \
            type(ref.cache_axes()).__name__


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_param_plans_equal_the_references(arch_id, mesh_name):
    sizes, axes = MESHES[mesh_name]
    rmesh = ref_sh.abstract_mesh(sizes, axes)
    rcfg = ref_configs.get_arch(arch_id).config
    pcfg = port_configs.get_arch(arch_id).config
    ref_params, ref_axes = ref_build(rcfg).init(None)
    port = port_build(pcfg, device="meta")
    shapes = {k: p for k, p in port.named_parameters()}
    for rules in ("TRAIN_RULES", "SERVE_RULES"):
        want = _names(ref_sh.plan_tree(rmesh, ref_params, ref_axes,
                                       getattr(ref_sh, rules)))
        got = port_sh.plan_tree(rmesh, shapes, port.param_axes(pcfg),
                                getattr(port_sh, rules))
        assert set(got) == set(want)
        for name, plan in got.items():
            assert plan.spec == _spec(want[name]), (rules, name)
            assert plan.placements == _implied(axes, plan.spec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_spec_equals_the_references(mesh_name):
    sizes, axes = MESHES[mesh_name]
    rmesh = ref_sh.abstract_mesh(sizes, axes)
    for ndim in (2, 3):
        for batch in (1, 2, 4, 8, 32, 128, 256):
            want = _spec(ref_sh.batch_spec(rmesh, ndim, batch))
            got = port_sh.batch_spec(rmesh, ndim, batch)
            assert got.spec == want, (ndim, batch)
            assert got.placements == _implied(axes, got.spec)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "2x2x2"])
@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_serve_shardings_equal_the_references(arch_id, mesh_name):
    sizes, axes = MESHES[mesh_name]
    rmesh = ref_sh.abstract_mesh(sizes, axes)
    shape = ref_configs.SHAPES["decode_32k"]
    rcfg = ref_configs.get_arch(arch_id).config
    pcfg = port_configs.get_arch(arch_id).config
    ref = ref_build(rcfg)
    ref_params, ref_axes = ref.init(None)
    port = port_build(pcfg, device="meta")
    want_p, want_c = ref_serve.serve_shardings(
        rmesh, ref, ref_params, ref_axes,
        ref_configs.cache_specs(rcfg, shape))
    got_p, got_c = port_serve.serve_shardings(
        rmesh, port, {k: p for k, p in port.named_parameters()},
        port.param_axes(pcfg),
        port_configs.cache_specs(pcfg, port_configs.SHAPES["decode_32k"]))
    want_p = _names(want_p)
    assert {k: v.spec for k, v in got_p.items()} == {
        k: _spec(v) for k, v in want_p.items()}
    assert [p.spec for p in got_c] == [_spec(s) for s in want_c]
    assert tuple(port_serve.cache_axes_for_mesh(port, rmesh)) == \
        tuple(ref_serve.cache_axes_for_mesh(ref, rmesh))


def test_input_and_cache_specs_equal_the_references():
    for arch_id in ARCH_IDS:
        rcfg = ref_configs.get_arch(arch_id).config
        pcfg = port_configs.get_arch(arch_id).config
        for sname, shape in ref_configs.SHAPES.items():
            pshape = port_configs.SHAPES[sname]
            want = ref_configs.input_specs(rcfg, shape)
            got = port_configs.input_specs(pcfg, pshape)
            assert {k: tuple(v.shape) for k, v in got.items()} == \
                {k: tuple(v.shape) for k, v in want.items()}
            assert all(v.device.type == "meta" for v in got.values())
            if shape.kind == "train":
                continue
            want_c = ref_configs.cache_specs(rcfg, shape)
            got_c = port_configs.cache_specs(pcfg, pshape)
            assert [tuple(t.shape) for t in got_c] == \
                [tuple(t.shape) for t in want_c], (arch_id, sname)


# ---------------------------------------------------------------------------
# the cases of tests/test_sharding.py, on the port
# ---------------------------------------------------------------------------

MESH = port_sh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
MESH_SINGLE = port_sh.abstract_mesh((16, 16), ("data", "model"))


def spec(mesh, shape, axes, rules=port_sh.TRAIN_RULES):
    return P(*port_sh.plan_sharding(mesh, shape, axes, rules).spec)


def test_tp_and_fsdp_dims():
    assert spec(MESH, (22, 2048, 2048), ("layers", "embed", "heads_flat")) \
        == P(None, "data", "model")


def test_vocab_tp():
    assert spec(MESH, (32000, 2048), ("vocab", "embed")) == P("model", "data")


def test_indivisible_head_fallback():
    assert spec(MESH, (40, 2560, 2560), ("layers", "embed", "heads_flat")) \
        == P(None, "data", "model")
    assert spec(MESH, (64, 4096, 20, 128), ("batch", None, "heads", None)) \
        == P(("pod", "data"), None, None, None)


def test_no_axis_reuse_within_array():
    s = spec(MESH, (1536, 4096), ("mlp", "vocab"))
    assert len([a for a in s if a == "model"]) == 1


def test_batch_over_pod_and_data():
    assert P(*port_sh.batch_spec(MESH, 2, 256).spec) == P(("pod", "data"), None)
    assert P(*port_sh.batch_spec(MESH_SINGLE, 2, 256).spec) == P("data", None)


def test_batch_indivisible_falls_back():
    assert P(*port_sh.batch_spec(MESH, 2, 1).spec) == P(None, None)


def test_serve_rules_no_fsdp():
    assert spec(MESH, (32000, 2048), ("vocab", "embed"),
                port_sh.SERVE_RULES) == P("model", None)


def test_experts_tp():
    assert spec(MESH, (94, 128, 4096, 1536),
                ("layers", "experts", "embed", "mlp")) == \
        P(None, "model", "data", None)


def test_kv_seq_fallback_logic():
    m = port_build(port_configs.get_arch("tinyllama-1.1b").config,
                   device="meta")  # kv=4, does not divide 16
    assert "seq_sharded" in port_serve.cache_axes_for_mesh(m, MESH).k
    m2 = port_build(port_configs.get_arch("stablelm-1.6b").config,
                    device="meta")  # kv=32 divides 16
    axes2 = port_serve.cache_axes_for_mesh(m2, MESH)
    assert "seq_sharded" not in axes2.k and "seq" in axes2.k


def test_two_axis_entry_is_pod_major():
    """``("pod", "data")`` splits its dim pod-major: rank (p, d) holds block
    ``p * D + d``, as JAX's NamedSharding does."""
    sizes = {"pod": 2, "data": 4, "model": 2}
    plan = port_sh.batch_spec(sizes, 2, 64)
    assert plan.placements == (Shard(0), Shard(0), Replicate())
    blocks = [port_sh.local_slices((64, 5), sizes, {"pod": p, "data": d,
                                                     "model": 0}, plan.spec)[0]
              for p in range(2) for d in range(4)]
    assert [(b.start, b.stop) for b in blocks] == [
        (8 * i, 8 * i + 8) for i in range(8)]


def test_plain_tensors_pass_constrain():
    """Outside ``activation_sharding``, or on a plain tensor, ``constrain``
    is the identity: the single-device paths are unchanged."""
    from repro_torch.models.common import constrain

    x = torch.ones(2, 3)
    assert constrain(x, ("batch", None)) is x
