"""The port's sharding rules (``repro_torch/parallel/sharding.py``)
against the JAX package's ``repro/parallel/sharding.py``: every
parameter leaf's spec for all ten configs, reduced and at full width (the
reference's shapes from ``jax.eval_shape``, the port's from fake
tensors), at model sizes 1, 2 and 16 with FSDP off and on; the batch and
decode-cache specs; and the mapping of specs to DTensor placements."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.parallel.sharding import batch_specs as j_batch_specs  # noqa: E402
from repro.parallel.sharding import (  # noqa: E402
    cache_partition_specs as j_cache_specs,
)
from repro.parallel.sharding import param_specs as j_param_specs  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch.specs import fake_params  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    batch_specs, cache_partition_specs, fsdp_min_off_stack, param_specs,
    strip_axis,
)
from repro_torch.models.lm import cache_specs  # noqa: E402
from repro_torch.tree import paths  # noqa: E402

#: (model size, FSDP): the production model axis, a small one, none
SETTINGS = [(m, fsdp) for m in (1, 2, 16) for fsdp in (False, True)]
DENSE = ("granite-3-2b", "glm4-9b", "codeqwen1.5-7b", "qwen2-72b")


def _ref_specs(cfg, **kw) -> dict:
    """{path without layer indices: tuple(spec)} of the reference."""
    sds = jax.eval_shape(lambda: JModel(cfg).init(jax.random.PRNGKey(0)))
    specs = j_param_specs(sds, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(e.key) for e in path): tuple(s) for path, s in flat}


def _port_tree(cfg):
    params, _ = fake_params(Model(cfg, device="cpu"))
    return params


def _kw(cfg, model_size, fsdp):
    return dict(model_size=model_size, fsdp_axis="data" if fsdp else None,
                fsdp_size=16, attention_shardable=cfg.num_heads % model_size == 0)


@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_match_the_reference(name, width):
    """Each leaf's spec is the reference's spec of its stacked leaf with
    the stacked axes' entries dropped; where the reference's FSDP shard
    lands on a stacked axis the port raises, naming that leaf (never for
    the dense family)."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    if width == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    tree = _port_tree(cfg)
    keys = paths(tree)
    checked = 0
    for model_size, fsdp in SETTINGS:
        kw = _kw(cfg, model_size, fsdp)
        want = _ref_specs(jcfg, **kw)
        stacked = {}
        for key in keys:
            parts = key.split("/")
            depth = sum(p.isdigit() for p in parts)
            ref = want["/".join(p for p in parts if not p.isdigit())]
            stacked[key] = (depth, ref)
        assert {"/".join(p for p in k.split("/") if not p.isdigit())
                for k in keys} == set(want)
        bad = [k for k, (d, ref) in stacked.items()
               if any(e is not None for e in ref[:d])]
        if bad:
            assert name not in DENSE
            with pytest.raises(NotImplementedError) as err:
                param_specs(tree, **kw)
            assert bad[0] in str(err.value)
            continue
        got = dict(zip(keys, _spec_leaves(param_specs(tree, **kw))))
        for key, (depth, ref) in stacked.items():
            assert got[key] == ref[depth:], (key, model_size, fsdp)
            checked += 1
    assert checked or name not in DENSE


def _spec_leaves(tree) -> list:
    """The spec tuples of a spec tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _spec_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


@pytest.mark.parametrize("axes", [("pod", "data"), ("data",)])
def test_batch_specs_match_the_reference(axes):
    want = {k: tuple(v) for k, v in j_batch_specs(axes).items()}
    assert batch_specs(axes) == want


@pytest.mark.parametrize("name", sorted(ARCHS))
@pytest.mark.parametrize("batch,seq", [(128, 32768), (1, 524288), (3, 100)])
def test_cache_partition_specs_match_the_reference(name, batch, seq):
    """Decode-cache specs over the port's ``cache_specs`` (the reference's
    stacked layouts), at the production mesh's sizes and a small one."""
    cfg = ARCHS[name]
    jm = JModel(J_ARCHS[name])
    tree = cache_specs(cfg, batch, seq)
    jtree = jm.cache_specs(batch, seq)
    for axes, model_size, total in ((("pod", "data"), 16, 32),
                                    (("data",), 16, 16), (("data",), 2, 2)):
        kw = dict(batch_axes=axes, model_size=model_size,
                  batch_size_total=total)
        want = j_cache_specs(jtree, **kw)
        got = cache_partition_specs(tree, **kw)
        flat, _ = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: isinstance(x, P))
        for path, spec in flat:
            node = got
            for e in path:
                node = node[e.key]
            assert node == tuple(spec), (path, kw)


def test_strip_axis_gives_the_tp_only_spec():
    assert strip_axis(("data", "model"), "data") == (None, "model")
    assert strip_axis((("pod", "data"), None), "data") == ("pod", None)
    assert strip_axis((None, "model"), "data") == (None, "model")


def test_fsdp_on_the_stacked_axis_raises_naming_the_leaf():
    """A layer leaf whose largest dim is its stacked axis (40 layers of a
    (2, 2) leaf over an FSDP size of 8) cannot be mirrored."""
    tree = {"layers": [{"w_gate": torch.empty(2, 2)} for _ in range(40)]}
    with pytest.raises(NotImplementedError, match="layers/0/w_gate"):
        param_specs(tree, model_size=1, fsdp_axis="data", fsdp_size=8,
                    fsdp_min_size=1)


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_fsdp_min_off_stack_is_the_least_size_that_does_not_raise(name):
    """Reduced granite shards every leaf from 1 element; reduced
    qwen2-moe's q/k/v biases (4 layers x 128) would land on the stacked
    axis, so the least threshold is one past their 512 elements, and one
    less raises naming a bias."""
    params = fake_params(Model(ARCHS[name].reduced(), device="cpu"))[0]
    kw = dict(model_size=2, fsdp_size=2)
    least = fsdp_min_off_stack(params, **kw)
    assert least == (513 if name == "qwen2-moe-a2.7b" else 1)
    param_specs(params, fsdp_axis="data", fsdp_min_size=least, **kw)
    if least > 1:
        with pytest.raises(NotImplementedError, match="/b[qkv]"):
            param_specs(params, fsdp_axis="data", fsdp_min_size=least - 1,
                        **kw)
