"""The port's launch arithmetic and cell builds (``repro_torch/launch/``)
against the JAX package's ``repro/launch/``: device coordinates, active
parameters, the microbatch count, every cell's analytic cost and
residency, the roofline given the reference's constants, ``build_cell``'s
``meta`` for the dense and MoE families' train and prefill cells on both
production meshes, the refusals, and the mapping of specs to DTensor
placements (FSDP's and ZeRO-2's "data" on the root mesh).  The port's meshes live on a fake process group of the
mesh's world size, as the dry run's do; the reference's production
meshes need 512 host devices, so its cells are built in a subprocess."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as J_ARCHS  # noqa: E402
from repro.launch import flops as j_flops  # noqa: E402
from repro.launch import mesh as j_mesh  # noqa: E402
from repro.launch.specs import active_params as j_active  # noqa: E402
from repro.launch.specs import count_params_tree as j_count  # noqa: E402
from repro.launch.specs import pick_grad_accum as j_pick  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes  # noqa: E402
from repro_torch.launch import flops  # noqa: E402
from repro_torch.launch.dryrun import roofline, start_fake_group  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    device_coords, make_production_mesh, step_mesh,
)
from repro_torch.launch.specs import (  # noqa: E402
    active_params, build_cell, check_cell, pick_grad_accum,
)

ROOT = Path(__file__).resolve().parent.parent
DENSE = ("granite-3-2b", "glm4-9b", "codeqwen1.5-7b", "qwen2-72b")
#: the archs whose train and prefill cells shard: the dense family and
#: the MoE without MLA
SHARDED = (*DENSE, "qwen2-moe-a2.7b")
IN_SCOPE = [(a, s) for a in SHARDED for s in ("train_4k", "prefill_32k")]
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}

#: the reference's cells on its production meshes (512 host devices)
_REF_META = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.configs import get_arch, get_shape
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import build_cell
out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for a, s in json.loads(sys.argv[1]):
        out[f"{'multi' if mp else 'single'}/{a}/{s}"] = build_cell(
            get_arch(a), get_shape(s), mesh).meta
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_meta():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _REF_META,
                          json.dumps(IN_SCOPE)], env=env, cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return json.loads(out.splitlines()[-1])


@pytest.fixture(scope="module")
def fake_world():
    """``start(world_size)``: a fake process group of that size (the dry
    run's), destroyed after the module."""
    import torch.distributed as dist

    yield start_fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _j_mesh(shape: dict):
    """A stand-in of the reference's mesh for ``device_coords``: device
    ids in C order over the axes."""
    n = int(np.prod(list(shape.values())))
    devs = np.array([types.SimpleNamespace(id=i) for i in range(n)],
                    dtype=object).reshape(tuple(shape.values()))
    return types.SimpleNamespace(devices=devs, shape=shape)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_device_coords_match_the_reference(tag, fake_world):
    """At the reference's 4 chips a host, on both production shapes."""
    fake_world(512 if tag == "multi" else 256)
    mesh = make_production_mesh(multi_pod=tag == "multi")
    want = j_mesh.device_coords(_j_mesh(MESHES[tag]))
    assert device_coords(mesh, chips_per_host=j_mesh.CHIPS_PER_HOST) == want
    # the port's own hosts: 8 GPUs, 32 hosts a pod
    mine = device_coords(mesh)
    assert len({h for _, h, _ in mine.values()}) == len(want) // 8
    assert max(c for _, _, c in mine.values()) == 7


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_active_params_and_grad_accum_match_the_reference(name):
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    n = j_count(jax.eval_shape(lambda: JModel(jcfg).init(
        jax.random.PRNGKey(0))))
    assert active_params(cfg, n) == j_active(jcfg, n)
    for shape in applicable_shapes(cfg):
        jshape = types.SimpleNamespace(**vars(shape))
        for shards in (1, 16, 32, 512):
            assert pick_grad_accum(cfg, shape, shards) == \
                j_pick(jcfg, jshape, shards)


def _cell_args(name, shape, tag):
    """The dry run's arguments of ``cell_cost``/``resident_bytes`` for a
    cell, from the reference's parameter count."""
    jcfg = J_ARCHS[name]
    n = j_count(jax.eval_shape(lambda: JModel(jcfg).init(
        jax.random.PRNGKey(0))))
    n_chips = int(np.prod(list(MESHES[tag].values())))
    fsdp = n >= 10_000_000_000 and shape.kind == "train"
    accum = j_pick(jcfg, shape, n_chips // 16) if shape.kind == "train" else 1
    opt = 4 if n > 100_000_000_000 and shape.kind == "train" else 8
    return n, dict(n_chips=n_chips, model_shards=16, grad_accum=accum,
                   fsdp=fsdp, opt_bytes_per_param=opt)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cell_cost_and_resident_bytes_match_every_cell(name):
    """Every (arch x applicable shape x mesh) cell, field for field."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    for shape in applicable_shapes(cfg):
        for tag in MESHES:
            n, kw = _cell_args(name, shape, tag)
            got = flops.cell_cost(cfg, shape, n_params=n,
                                  data_shards=kw["n_chips"] // 16, **kw)
            want = j_flops.cell_cost(jcfg, shape, n_params=n,
                                     data_shards=kw["n_chips"] // 16, **kw)
            assert vars(got) == vars(want), (name, shape.name, tag)
            assert flops.resident_bytes(cfg, shape, n_params=n, **kw) == \
                j_flops.resident_bytes(jcfg, shape, n_params=n, **kw)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_roofline_given_the_reference_constants(name):
    """``dryrun.roofline`` with the TPU v5e's constants gives the terms the
    reference's ``run_cell`` computes (``repro/launch/dryrun.py``)."""
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    wire = 123_456_789
    for shape in applicable_shapes(cfg):
        for tag in MESHES:
            n, kw = _cell_args(name, shape, tag)
            meta = {"params": n, "active_params": j_active(jcfg, n),
                    "grad_accum": kw["grad_accum"], "fsdp": kw["fsdp"],
                    "opt_state_dtype": "bfloat16"
                    if kw["opt_bytes_per_param"] == 4 else "float32"}
            _, got = roofline(cfg, shape, meta, n_chips=kw["n_chips"],
                              model_shards=16, wire_bytes=wire,
                              peak_flops=j_mesh.PEAK_FLOPS_BF16,
                              hbm_bw=j_mesh.HBM_BW,
                              link_bw=j_mesh.ICI_LINK_BW)
            # the reference's run_cell, lines 90-113
            ac = j_flops.cell_cost(jcfg, shape, n_params=n,
                                   data_shards=kw["n_chips"] // 16, **kw)
            flops_dev = ac.total_flops / kw["n_chips"]
            terms = {"compute_s": flops_dev / j_mesh.PEAK_FLOPS_BF16,
                     "memory_s": ac.hbm_bytes / j_mesh.HBM_BW,
                     "collective_s": wire / j_mesh.ICI_LINK_BW}
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)
            mult = 6 if shape.kind == "train" else 2
            model_dev = mult * meta["active_params"] * tokens / kw["n_chips"]
            want = {**terms, "dominant": max(terms, key=terms.get),
                    "model_flops_per_dev": model_dev,
                    "useful_flop_ratio": model_dev / flops_dev,
                    "bound_s": max(terms.values())}
            assert got == want, (name, shape.name, tag)


@pytest.mark.parametrize("tag", sorted(MESHES))
def test_build_cell_meta_matches_the_reference(tag, reference_meta,
                                               fake_world):
    """The dense and MoE families' train and prefill cells: the same
    ``meta`` (parameter counts, FSDP at qwen2-72b's and qwen2-moe's
    training, the microbatch count, the optimizer state's type, the
    mesh)."""
    fake_world(512 if tag == "multi" else 256)
    mesh = make_production_mesh(multi_pod=tag == "multi")
    for a, s in IN_SCOPE:
        got = build_cell(ARCHS[a], SHAPES[s], mesh).meta
        assert got == reference_meta[f"{tag}/{a}/{s}"], (a, s)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cells_outside_the_scope_refuse_naming_family_or_shape(name):
    cfg = ARCHS[name]
    for shape in applicable_shapes(cfg):
        if name in SHARDED and shape.kind in ("train", "prefill"):
            check_cell(cfg, shape)
            continue
        with pytest.raises(NotImplementedError) as err:
            check_cell(cfg, shape)
        msg = str(err.value)
        assert (shape.kind in msg if shape.kind not in ("train", "prefill")
                else cfg.family in msg)
        if cfg.mla and shape.kind in ("train", "prefill"):
            assert "MLA" in msg


def test_check_cell_admits_the_moe_without_mla():
    """qwen2-moe's train and prefill cells are admitted and built expert
    parallel; deepseek-v2-lite's (the MoE family with MLA) refuse naming
    MLA, the hybrid's naming its family, and decode refuses by kind."""
    moe, mla = ARCHS["qwen2-moe-a2.7b"], ARCHS["deepseek-v2-lite-16b"]
    assert moe.family == mla.family == "moe" and mla.mla and not moe.mla
    for s in ("train_4k", "prefill_32k"):
        check_cell(moe, SHAPES[s])
        with pytest.raises(NotImplementedError, match="MLA"):
            check_cell(mla, SHAPES[s])
        with pytest.raises(NotImplementedError, match="'hybrid'"):
            check_cell(ARCHS["jamba-1.5-large-398b"], SHAPES[s])
    with pytest.raises(NotImplementedError, match="decode"):
        check_cell(moe, SHAPES["decode_32k"])


def test_specs_map_to_placements_on_the_flattened_mesh(fake_world):
    """On the two-pod mesh the step's mesh is ('pod_data', 'model') over
    the same ranks; the batch's ("pod", "data") shards over 'pod_data',
    "model" over 'model'.  FSDP's "data" names part of 'pod_data': it
    has no placement there, and ``place`` puts its leaf on the root
    mesh the step mesh was flattened from, sharded over 'data' and
    replicated over 'pod', as the reference shards it.  The root keeps
    the step mesh: asking again, as the traced step does for its leaves,
    gives the same mesh."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import place, root_mesh, to_placements

    fake_world(512)
    root = make_production_mesh(multi_pod=True)
    mesh = step_mesh(root)
    assert mesh.mesh_dim_names == ("pod_data", "model")
    assert tuple(mesh.mesh.shape) == (32, 16)
    assert root_mesh(mesh) is root and root_mesh(root) is root
    assert step_mesh(root) is mesh
    assert to_placements(mesh, (("pod", "data"), None, None)) == \
        (Shard(0), Replicate())
    assert to_placements(mesh, (None, "model")) == (Replicate(), Shard(1))
    assert place(mesh, (None, "model")) == \
        (mesh, (Replicate(), Shard(1)))
    with pytest.raises(ValueError):
        to_placements(mesh, ("data", "model"))
    on, pl = place(mesh, ("data", "model"))
    assert on is root and pl == (Replicate(), Shard(0), Shard(1))
    with pytest.raises(ValueError):
        to_placements(mesh, ("model", "model"))
    # one pod: 'data' is a whole dim, and every leaf stays on the one mesh
    fake_world(256)
    single = make_production_mesh()
    assert step_mesh(single) is single
    assert place(single, ("data", "model")) == \
        (single, (Shard(0), Shard(1)))


def test_fsdp_threshold_is_a_module_constant(fake_world, monkeypatch):
    """``build_cell`` reads ``FSDP_MIN_PARAMS`` (the reference's
    ``fsdp_threshold_params``): granite's train cell runs FSDP when it is
    lowered below granite's size, sized by 'data', not the pods."""
    from repro_torch.launch import specs

    fake_world(512)
    mesh = make_production_mesh(multi_pod=True)
    cell = build_cell(ARCHS["granite-3-2b"], SHAPES["train_4k"], mesh)
    assert not cell.meta["fsdp"]
    monkeypatch.setattr(specs, "FSDP_MIN_PARAMS", 0)
    cell = build_cell(ARCHS["granite-3-2b"], SHAPES["train_4k"], mesh)
    assert cell.meta["fsdp"]
    # the embedding (49,155 x 2,048): vocab over 'model' does not divide,
    # so the model dim stays whole and FSDP splits 2,048 by 'data' (16)
    emb = cell.args[0]["embed"]
    assert tuple(emb.shape) == (49155, 2048 // 16)
