"""The port's sharding rules (``launch/sharding.py``,
``models/sharding_ctx.py``), roofline (``launch/roofline.py``) and abstract
state against the reference's pure functions, exactly: every leaf of all ten
configs' param schema under "tp" and "fsdp", every cache leaf at each
applicable shape (long_500k's batch of 1 included), the activation rules,
``cell_is_applicable`` and ``model_flops`` on all 40 (arch, shape) pairs,
``make_terms`` with the constants injected, the abstract params, optimizer
state and caches against the reference's ``ShapeDtypeStruct`` trees, on
``FakeMesh`` objects (tests/test_sharding.py:38-45) at 1 × 1, 16 × 16 and
2 × 16 × 16. ``batch_sharding`` builds a ``NamedSharding``, which needs a
real mesh: its specs come from one subprocess on 512 placeholder CPU
devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import cell_is_applicable as jcell_is_applicable  # noqa: E402
from repro.configs.base import get_config as jget_config  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.launch.steps import abstract_state as jabstract_state  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.param import is_leaf as jis_leaf  # noqa: E402
from repro.models.sharding_ctx import rules_to_spec as jrules_to_spec  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    SHAPES, cell_is_applicable, get_config, list_configs,
)
from repro_torch.launch import roofline, sharding  # noqa: E402
from repro_torch.launch.steps import abstract_state, input_specs  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.param import is_leaf, leaves  # noqa: E402
from repro_torch.models.sharding_ctx import (  # noqa: E402
    PartitionSpec, axis_names, rules_to_spec, shard, to_placements,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list_configs()


def from_placements(placements, ndim: int, mesh) -> PartitionSpec:
    """``to_placements``' inverse (``Shard`` entries only)."""
    names = axis_names(mesh)
    entries: list = [[] for _ in range(ndim)]
    for j, pl in enumerate(placements):
        if pl.is_shard():
            entries[pl.dim % ndim].append(names[j])
    return PartitionSpec(*(tuple(e) if len(e) > 1 else (e[0] if e else None)
                           for e in entries))


class FakeMesh:
    def __init__(self, shape: dict):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)


MESHES = {
    "1x1": FakeMesh({"data": 1, "model": 1}),
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
}
JRULES = {"tp": jsharding.PARAM_RULES, "fsdp": jsharding.PARAM_RULES_FSDP}


def _t(spec) -> tuple:
    return tuple(spec)


def _jleaves(tree, prefix=()):
    """(path, leaf) of a reference tree in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _jleaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _pairs():
    return [(a, s) for a in ARCHS for s in SHAPES]


def test_ten_configs_and_four_shapes():
    assert ARCHS == sorted(jget_config(a).name for a in ARCHS) and len(ARCHS) == 10
    assert list(SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(arch, mesh, profile):
    m = MESHES[mesh]
    jschema = jmodel.param_schema(jget_config(arch))
    jl = list(_jleaves(jschema))
    tl = list(leaves(model.param_schema(get_config(arch))))
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, p), (_, jp) in zip(tl, jl):
        assert is_leaf(p) and jis_leaf(jp)
        assert (p.shape, p.axes) == (tuple(jp.shape), tuple(jp.axes)), path
        jspec = jsharding.evenize_spec(jsharding.spec_for_axes(jp.axes, m, JRULES[profile]),
                                       jp.shape, m)
        rules = sharding.PARAM_RULES if profile == "tp" else sharding.PARAM_RULES_FSDP
        spec = sharding.evenize_spec(sharding.spec_for_axes(p.axes, m, rules), p.shape, m)
        assert _t(spec) == _t(jspec), path
        assert _t(sharding.param_spec(p, m, profile)) == _t(jspec), path
        assert _t(sharding.param_shardings(p, m, profile).spec) == _t(jspec), path
        # the placements name the same axes back, but for the mesh's size-1 axes
        split = PartitionSpec(*(tuple(a for a in ((e,) if isinstance(e, str) else (e or ()))
                                      if m.shape[a] > 1) or None for e in spec))
        split = PartitionSpec(*(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                for e in split))
        assert _t(from_placements(to_placements(spec, m), len(spec), m)) == _t(split), path


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        if not cell_is_applicable(cfg, shape)[0] or shape.mode == "train":
            continue
        b = shape.global_batch
        jcache = jmodel.abstract_cache(jcfg, b, shape.seq_len)
        tcache = model.abstract_cache(cfg, b, shape.seq_len)
        jl, tl = list(_jleaves(jcache)), list(_jleaves(tcache))
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, t), (_, j) in zip(tl, jl):
            key = "/".join(path)
            assert tuple(t.shape) == tuple(j.shape) and str(t.dtype)[6:] == str(j.dtype), key
            jspec = jsharding._cache_spec(key, tuple(j.shape), m, b)
            assert _t(sharding._cache_spec(key, tuple(t.shape), m, b)) == _t(jspec), (key, name)
        # the port's per-layer buffers take the stacked leaf's spec without its lead
        flat = sharding.cache_shardings(
            model.zero_cache(cfg, b, shape.seq_len, torch.bfloat16, "meta"), m, b)
        for key_path, sh in _sharding_leaves(flat):
            jl_shape = dict(("/".join(p), j) for p, j in jl)[key_path]
            lead = len(jl_shape.shape) - len(sh.spec)
            jspec = jsharding._cache_spec(key_path, tuple(jl_shape.shape), m, b)
            assert _t(sh.spec) == _t(jspec)[lead:], (key_path, name)


def _sharding_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sharding_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for t in tree:
            yield from _sharding_leaves(t, prefix)
    else:
        yield "/".join(prefix), tree


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_rules_and_rules_to_spec(mesh, profile):
    m = MESHES[mesh]
    rules = sharding.activation_rules(m, profile)
    assert rules == jsharding.activation_rules(m, profile)
    logical = [("batch", "seq_act", None), ("batch", "experts_act", None, "mlp_act"),
               ("batch", "seq", "vocab_act"), ("batch", None, "heads_act", None),
               ("batch", "heads_act", None, None), ("batch", "seq", "mlp_act")]
    for lg in logical:
        assert _t(rules_to_spec(rules, lg)) == _t(jrules_to_spec(rules, lg)), lg


def test_rules_to_spec_dedup():
    rules = {"batch": "data", "experts_act": "model", "mlp_act": "model"}
    lg = ("batch", "experts_act", None, "mlp_act")
    assert rules_to_spec(rules, lg) == PartitionSpec("data", "model", None, None)
    assert _t(rules_to_spec(rules, lg)) == _t(jrules_to_spec(rules, lg))


def test_evenize_drops_on_16x16():
    m = MESHES["16x16"]
    assert sharding.evenize_spec(PartitionSpec("model", "data"), (50280, 2048), m) \
        == PartitionSpec(None, "data")
    assert sharding.evenize_spec(PartitionSpec("model", None), (50304, 2048), m) \
        == PartitionSpec("model", None)


@pytest.mark.parametrize("arch,shape", _pairs())
def test_cell_is_applicable_matches(arch, shape):
    assert cell_is_applicable(get_config(arch), SHAPES[shape]) \
        == jcell_is_applicable(jget_config(arch), JSHAPES[shape])


@pytest.mark.parametrize("arch,shape", _pairs())
def test_model_flops_matches(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    n = model.active_param_count(cfg)
    assert n == jmodel.active_param_count(jcfg)
    got = roofline.model_flops(cfg, SHAPES[shape], n)
    want = jroofline.model_flops(jcfg, JSHAPES[shape], n)
    assert abs(got - want) <= 1e-12 * abs(want)
    assert roofline._attention_layers(cfg) == jroofline._attention_layers(jcfg)


def test_make_terms_with_the_constants_injected(monkeypatch):
    """The port's formulas with the reference's v5e constants give the
    reference's terms; the port's own defaults are the H100's."""
    args = (3.1e15, 7.7e12, 2.9e11, 1.8e15, 256)
    ref = jroofline.make_terms(*args)
    got = roofline.make_terms(*args, peak_flops=jroofline.PEAK_FLOPS,
                              hbm_bw=jroofline.HBM_BW, link_bw=jroofline.ICI_BW)
    for f in ("compute_s", "memory_s", "collective_s", "hlo_flops", "hlo_bytes",
              "collective_bytes", "model_flops", "chips", "dominant", "step_time_s",
              "useful_fraction", "mfu"):
        assert getattr(got, f) == getattr(ref, f), f
    # and the reference's, injected with the H100's, gives the port's defaults
    for name, value in (("PEAK_FLOPS", roofline.PEAK_FLOPS), ("HBM_BW", roofline.HBM_BW),
                        ("ICI_BW", roofline.LINK_BW)):
        monkeypatch.setattr(jroofline, name, value)
    ref, got = jroofline.make_terms(*args), roofline.make_terms(*args)
    assert (got.compute_s, got.memory_s, got.collective_s, got.mfu) \
        == (ref.compute_s, ref.memory_s, ref.collective_s, ref.mfu)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


def _buffers(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _buffers(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _buffers(t, prefix + (i,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_the_dry_runs_cache_is_the_abstract_cache_per_layer(arch):
    """The dry run's cache (``per_layer_cache`` of ``abstract_cache``, the tree
    held against the reference's above) has the structure, shapes and dtypes
    of the cache the model runs on (``zero_cache``)."""
    from repro_torch.launch.dryrun import per_layer_cache

    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    b, n = shape.global_batch, shape.seq_len
    got = list(_buffers(per_layer_cache(cfg, model.abstract_cache(cfg, b, n))))
    want = list(_buffers(model.zero_cache(cfg, b, n, torch.bfloat16, "meta")))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, w) in zip(got, want):
        assert (t.shape, t.dtype, t.device.type) == (w.shape, w.dtype, "meta"), path


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_state_matches_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    params, opt = abstract_state(cfg)
    jparams, jopt = jabstract_state(jcfg)
    for tree, jtree in ((params, jparams), (opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        tl, jl = list(_jleaves(tree)), list(_jleaves(jtree))
        assert [p for p, _ in tl] == [p for p, _ in jl]
        for (path, t), (_, j) in zip(tl, jl):
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t.dtype)) == (tuple(j.shape), str(j.dtype)), path
    assert (tuple(opt.step.shape), _dtype_name(opt.step.dtype)) \
        == (tuple(jopt.step.shape), str(jopt.step.dtype))
    assert _dtype_name(opt.mu["embed"]["tok"].dtype) == "bfloat16"
    assert _dtype_name(opt.nu["embed"]["tok"].dtype) == "float32"
    axes = model.model_logical_axes(cfg)
    jaxes = jmodel.model_logical_axes(jcfg)
    assert [a for _, a in _jleaves(axes)] == [tuple(a) for _, a in _jleaves(
        jax.tree.map(lambda x: x, jaxes, is_leaf=lambda x: isinstance(x, tuple)))]


def test_to_placements_round_trips_and_refuses_bad_specs():
    from torch.distributed.tensor import Replicate, Shard

    m = MESHES["2x16x16"]
    spec = PartitionSpec(("pod", "data"), None, "model")
    pl = to_placements(spec, m)
    assert pl == (Shard(0), Shard(0), Shard(2))
    assert from_placements(pl, 3, m) == spec
    assert to_placements(PartitionSpec(), m) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        to_placements(PartitionSpec(("data", "pod")), m)  # not the mesh's order
    with pytest.raises(ValueError):
        to_placements(PartitionSpec("data", "data"), m)
    with pytest.raises(ValueError):
        to_placements(PartitionSpec("expert"), m)


def test_shard_outside_a_context_is_the_tensor_itself():
    x = torch.randn(2, 3, 4)
    assert shard(x, "batch", "seq_act", None) is x
    assert shard(x) is x


_BATCH_SPECS = textwrap.dedent("""
    import os, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    from repro.configs.base import SHAPES, get_config, list_configs
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh, make_production_mesh
    from repro.launch.sharding import batch_sharding
    out = {}
    meshes = {"1x1": make_host_mesh(), "16x16": make_production_mesh(),
              "2x16x16": make_production_mesh(multi_pod=True)}
    for tag, mesh in meshes.items():
        for a in list_configs():
            for s, shape in SHAPES.items():
                for k, v in steps.input_specs(get_config(a), shape).items():
                    if k == "cache_index":
                        continue
                    spec = batch_sharding(mesh, v.shape, shape.global_batch).spec
                    out["|".join((tag, a, s, k))] = [list(e) if isinstance(e, tuple) else e
                                                     for e in spec]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def batch_specs():
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", _BATCH_SPECS], capture_output=True, text=True,
                       timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_sharding_specs_match_the_reference(batch_specs, mesh):
    m = MESHES[mesh]
    n = 0
    for a in ARCHS:
        for s, shape in SHAPES.items():
            for k, v in input_specs(get_config(a), shape).items():
                if k == "cache_index":
                    continue
                want = [tuple(e) if isinstance(e, list) else e
                        for e in batch_specs["|".join((mesh, a, s, k))]]
                got = sharding.batch_sharding(m, tuple(v.shape), shape.global_batch).spec
                assert list(got) == want, (a, s, k)
                n += 1
    assert n == sum(k.startswith(mesh + "|") for k in batch_specs) > 40
    assert sharding.replicated(m).spec == PartitionSpec()


def test_reference_models_agree_on_params_count():
    for a in ARCHS:
        assert model.count_params(get_config(a)) == jmodel.count_params(jget_config(a))
