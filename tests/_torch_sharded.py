"""The ranks of the port's multi-process CPU checks: one reduced train
step (with accumulation) and one prefill, sharded by DTensor over a gloo
process group: granite's, or the MoE's expert parallel.  Imports no JAX:
``torch.multiprocessing`` starts each rank in a fresh interpreter that
imports this module."""

import torch
import torch.distributed as dist


def rank_main(rank: int, world: int, shape: tuple, port: int, params,
              batch: dict, steps_kw: dict, out: str) -> None:
    """One rank: the sharded step on ``shape``'s mesh over ``params``
    (whole, the same on every rank), then a prefill of the batch's
    tokens.  Rank 0 saves {loss, grad_norm, params (whole), logits, the
    step's collective counts by op} to ``out``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.debug import CommDebugMode

        from repro_torch.launch.mesh import batch_axes, step_mesh
        from repro_torch.models import Model
        from repro_torch.parallel.sharding import (
            fsdp_min_off_stack, map_specs, param_specs, shard_tree,
            strip_axis,
        )
        from repro_torch.train import (
            AdamWConfig, TrainConfig, adamw_init, make_train_step,
        )
        from repro_torch.train.step import shard_batch
        from repro_torch.tree import leaves, rebuild

        names = ("pod", "data", "model")[-len(shape):]
        full = init_device_mesh("cpu", shape, mesh_dim_names=names)
        mesh = step_mesh(full)
        cfg = steps_kw["cfg"]
        axes = batch_axes(full)
        # the spawn hands every rank the same shared-memory storage: each
        # rank's shards (updated in place) must be its own
        params = rebuild(params, [t.clone() for t in leaves(params)])
        tp = shape[-1]
        hooks = {}
        data = shape[-2]
        if steps_kw["fsdp"]:
            # every leaf that can be: FSDP over 'data' within a pod, each
            # layer gathered to its TP-only spec at use (launch/specs.py's
            # hooks); the leaves whose shard the reference puts on the
            # stacked layer axis (the MoE's q/k/v biases) stay whole
            specs = param_specs(params, model_size=tp, fsdp_axis="data",
                                fsdp_size=data,
                                fsdp_min_size=fsdp_min_off_stack(
                                    params, model_size=tp, fsdp_size=data))
            hooks["layer_specs"] = map_specs(
                lambda _, s: strip_axis(s, "data"), specs["layers"][0],
                specs["layers"][0])
            accum_specs = None
        else:
            specs = param_specs(params, model_size=tp)
            accum_specs = param_specs(params, model_size=tp, fsdp_axis="data",
                                      fsdp_size=data, fsdp_min_size=1 << 20)
        if cfg.moe is None:     # the MoE's activations are not pinned
            hooks["act_spec"] = (axes if len(axes) > 1 else axes[0], None,
                                 None)
        model = Model(cfg, device="cpu", **hooks)
        sharded = shard_tree(params, mesh, specs)
        tc = TrainConfig(optimizer=AdamWConfig(), grad_accum=steps_kw["accum"],
                         batch_axes=axes, accum_specs=accum_specs)
        with CommDebugMode() as comm:
            sharded, _, metrics = make_train_step(model, tc)(
                sharded, adamw_init(sharded, tc.optimizer), batch)
        counts = {str(k): v for k, v in comm.get_comm_counts().items()}
        whole = [t.full_tensor() for t in leaves(sharded)]
        tokens = {"tokens": torch.from_numpy(batch["tokens"])}
        logits = model.prefill(sharded, shard_batch(tokens, mesh)).full_tensor()
        if rank == 0:
            torch.save({"loss": metrics["loss"], "grad_norm":
                        metrics["grad_norm"], "params": whole,
                        "logits": logits, "counts": counts}, out)
    finally:
        dist.destroy_process_group()
