"""Production training launcher: the port of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch granite-3-2b --steps 100
    python -m repro_torch.launch.train --arch granite-3-2b --reduced --device cpu

It runs on the card unless ``--device cpu`` is given.  It starts a
one-process group (NCCL on the card, gloo on the CPU) on a
``tcp://localhost`` port of its own, builds the ('data', 'model') mesh
over it, places
the state by ``param_specs`` as DTensors and runs the sharded train step
(``train/step.py``) with checkpoints, ``run_with_restarts`` and the
straggler detector, as the reference's ``main`` does.  Nothing falls
back: on the card a failure of NCCL, the mesh or the flash kernel
raises.

``--fail-at-step N`` raises a simulated ``HostFailure`` once, after
step N's checkpoint, so that the run restarts from it: the restart path
the reference's loop has but never takes on one host.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import socket
import time

import torch
import torch.distributed as dist

from ..checkpoint import latest_step, restore, save
from ..configs import get_arch
from ..data import SyntheticDataset
from ..ft import HostFailure, StragglerDetector, run_with_restarts
from ..models import Model
from ..parallel.sharding import (
    is_dtensor, map_specs, param_specs, shard_tree, to_placements,
)
from ..train import AdamWConfig, TrainConfig, adamw_init, make_train_step
from ..tree import leaves, rebuild
from .specs import count_params_tree, fake_params


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_group(device: torch.device) -> bool:
    """A one-process group for ``device`` (NCCL on the card, gloo on the
    CPU) on a free localhost port, unless one is running.  Returns
    whether this call started it."""
    if dist.is_initialized():
        return False
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    return True


def _local_state(state):
    """This rank's shards of a state tree of DTensors (and plain
    tensors), for its checkpoint."""
    return rebuild(state, [t.to_local() if is_dtensor(t) else t
                           for t in leaves(state)])


def _wrap(local, whole, mesh, specs):
    """Restored local shards as DTensors placed by ``specs``, with the
    whole shapes of ``whole``."""
    from torch.distributed.tensor import DTensor

    flat = iter(leaves(whole))

    def one(t, spec):
        w = next(flat)
        return DTensor.from_local(t, mesh, to_placements(mesh, spec),
                                  run_check=False, shape=w.shape,
                                  stride=w.stride())
    return map_specs(one, local, specs)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--state-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="AdamW's moments (bfloat16 halves the state and "
                         "its checkpoints)")
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="simulate one host failure after this step")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the launcher; returns its record (per-step seconds, loss and
    grad norm, tokens/s, peak device bytes, restarts)."""
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    started = start_group(device)
    try:
        mesh = init_device_mesh(device.type, (dist.get_world_size(), 1),
                                mesh_dim_names=("data", "model"))
        if device.type == "cuda":
            torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
            device = torch.device("cuda", torch.cuda.current_device())
        return _train(args, cfg, mesh, device)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, cfg, mesh, device) -> dict:
    data, mp = (int(n) for n in mesh.mesh.shape)
    model = Model(cfg, device=device, act_spec=("data", None, None))
    # whole shapes without memory: the specs and a restore's template
    whole, fake_mode = fake_params(dataclasses.replace(
        model, device=torch.device("cpu")))
    specs = param_specs(whole, model_size=mp)
    tc = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr,
                              warmup_steps=min(20, args.steps // 5),
                              decay_steps=args.steps,
                              state_dtype=args.state_dtype),
        grad_accum=args.grad_accum, batch_axes=("data",),
        # ZeRO-2 accumulators, as the dry run's cells have them
        accum_specs=param_specs(whole, model_size=mp, fsdp_axis="data",
                                fsdp_size=data, fsdp_min_size=1 << 20)
        if args.grad_accum > 1 else None)
    step_fn = make_train_step(model, tc)
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.global_batch, seed=0)
    detector = StragglerDetector()
    host = f"host-{dist.get_rank()}"
    ckpt = (None if args.ckpt_dir is None else
            os.path.join(args.ckpt_dir, f"rank_{dist.get_rank()}"))
    record = {"arch": cfg.name, "mesh": {"data": data, "model": mp},
              "device": str(device), "seq": args.seq,
              "global_batch": args.global_batch, "grad_accum": args.grad_accum,
              "params": count_params_tree(whole),
              "steps": [], "restarts": 0, "restored_from": [],
              "checkpoint_s": [], "restore_s": []}
    failed = []

    def train_loop(_s: int) -> int:
        if ckpt and latest_step(ckpt) is not None:
            sdt = torch.bfloat16 if tc.optimizer.state_dtype == "bfloat16" \
                else torch.float32
            with fake_mode:
                moments = rebuild(whole, [t.to(sdt) for t in leaves(whole)])
                template = {"params": whole, "opt": {
                    "m": moments, "v": moments,
                    "step": torch.zeros((), dtype=torch.int32)}}
            t0 = time.perf_counter()
            restored, s0 = restore(ckpt, template, device=device)
            record["restore_s"].append(time.perf_counter() - t0)
            params = _wrap(restored["params"], whole, mesh, specs)
            opt = {k: _wrap(restored["opt"][k], whole, mesh, specs)
                   for k in ("m", "v")}
            opt["step"] = restored["opt"]["step"]
            del restored
            record["restored_from"].append(s0)
            print(f"[restore] step {s0}", flush=True)
        else:
            params = shard_tree(model.init(0), mesh, specs)
            opt = adamw_init(params, tc.optimizer)
            s0 = 0
            print(f"[init] {cfg.name}: {record['params'] / 1e6:.1f}M params, "
                  f"mesh {record['mesh']} on {device}", flush=True)
        for i in range(s0, args.steps):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, metrics = step_fn(params, opt, ds.batch(i))
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t0      # float() waited for the step
            detector.record(host, dt)
            record["steps"].append({"step": i + 1, "s": dt, "loss": loss,
                                    "grad_norm": gnorm})
            if ckpt and ((i + 1) % args.ckpt_every == 0 or i + 1 == args.steps):
                t0 = time.perf_counter()
                save(ckpt, i + 1, _local_state({"params": params, "opt": opt}))
                record["checkpoint_s"].append(time.perf_counter() - t0)
            if (i + 1) % args.log_every == 0 or i == s0:
                print(f"step {i + 1:5d}  loss={loss:.4f}  gnorm={gnorm:.2f}  "
                      f"{dt:.2f}s", flush=True)
            if args.fail_at_step == i + 1 and not failed:
                failed.append(i + 1)
                raise HostFailure(f"simulated host failure after step {i + 1}")
        for rep in detector.check():
            print(f"[straggler] {rep.host}: {rep.ratio:.2f}x median -> "
                  f"{rep.advice}", flush=True)
        return args.steps

    def on_restart(n: int) -> None:
        record["restarts"] = n
        print(f"[restart] {n}", flush=True)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    run_with_restarts(train_loop, on_restart=on_restart)
    if device.type == "cuda":
        record["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    tokens = args.global_batch * args.seq
    times = sorted(s["s"] for s in record["steps"])
    record["step_s_median"] = times[len(times) // 2]
    record["tokens_per_s"] = tokens / record["step_s_median"]
    return record


if __name__ == "__main__":
    main()
