"""End-to-end training loop with checkpoint/restart fault tolerance (a
copy of the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron_8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 10 --device cpu

Fault tolerance model, as in the reference:
  * checkpoints are atomic and elastic (see ``repro_torch.checkpoint``)
    and in the reference's format, so either package resumes the other's,
    on any mesh;
  * --resume restarts from the newest complete checkpoint, bitwise-exact,
    because the data pipeline is stateless in step;
  * --fail-at simulates a hard crash mid-run;
  * --skip-anomalous-grads counts steps whose global grad-norm exceeds the
    limit. Like the reference (``src/repro/launch/train.py``, whose two
    branches both adopt the step's update), it still keeps their update,
    so that a run equals the reference's.

Runs on ``--device`` (cuda unless told otherwise); nothing falls back to
the CPU. ``train_loop(..., mesh=)`` is the reference's host-mesh path: on
a ``DeviceMesh`` of a host world (``launch.mesh.host_world``: one rank a
card over NCCL, or gloo ranks on the CPU) every rank trains the
partitioned LM on its "data" shard of each batch, and the checkpoint's
``mesh`` is the real ``[dp, tp]``. The CLI runs so under
``torch.distributed.run``, and started plainly on a host of several cards
it starts one rank a card itself; on one card it runs the one-device path
(``mesh`` ``[1, 1]``).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint import checkpoint as ckpt
from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device, set_default_device
from ..models.model import LM, param_specs
from ..optim import adamw
from . import mesh as mesh_mod
from .steps import init_opt_state, make_train_step, opt_state_specs


def _tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"blocks.attn.wq": t} -> {"blocks": {"attn": {"wq": t}}}."""
    return ckpt._unflatten({k.replace(".", "/"): v for k, v in flat.items()})


def _dotted(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k.replace("/", "."): v for k, v in ckpt._flatten(tree).items()}


def _save(ckpt_dir: str, step: int, lm: LM, opt_state: Dict[str, Any],
          seed: int, arch: str) -> None:
    """The reference's checkpoint of params and AdamW state; on a mesh
    every rank calls it (each leaf is gathered) and rank 0 writes."""
    shape = [int(n) for n in lm.mesh.shape] if lm.mesh is not None \
        else [1, 1]
    ckpt.save(ckpt_dir, step,
              {"params": _tree(lm.state_dict()),
               "opt": {"m": _tree(opt_state["m"]), "v": _tree(opt_state["v"]),
                       "step": opt_state["step"]}},
              extra={"data_cursor": step, "seed": seed, "arch": arch,
                     "mesh": shape})


def state_specs(lm: LM) -> Dict[str, Any]:
    """The specs of the training state of the partitioned ``lm`` as a tree
    of the checkpoint's structure: the parameters' and the AdamW state's
    (``steps.opt_state_specs``)."""
    sspecs = opt_state_specs(lm.cfg, lm.spec_mesh)
    return {"params": _tree(param_specs(lm.cfg, lm.spec_mesh)),
            "opt": {"m": _tree(sspecs["m"]), "v": _tree(sspecs["v"]),
                    "step": sspecs["step"]}}


def _batch(lm: LM, local: Dict[str, Any], global_batch: int,
           dev: torch.device) -> Dict[str, torch.Tensor]:
    """A batch on ``dev``; on a mesh each array (this rank's rows) becomes
    a DTensor whose batch axis is split over the data axes."""
    return {k: lm.rows(torch.from_numpy(v).to(dev), global_batch)
            for k, v in local.items()}


def _value(t: Any) -> float:
    """A metric as a float (a replicated DTensor's local value)."""
    if isinstance(t, torch.Tensor) and hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return float(t)


def train_loop(cfg, *, steps: int = 20, global_batch: int = 8,
               seq_len: int = 64, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 0, resume: bool = False,
               fail_at: Optional[int] = None, seed: int = 0,
               skip_anomalous_grads: bool = False,
               grad_norm_limit: float = 1e3, device=None, mesh=None,
               log_every: int = 5) -> Dict[str, Any]:
    """Train ``cfg`` from seeded weights (or resume from ``ckpt_dir``) for
    ``steps`` steps of ``SyntheticLM(seed)``. Returns the last step's
    metrics as floats, ``skipped_steps``, ``params`` (the LM's state dict,
    on ``device``) and ``opt_state`` (the AdamW state; the reference does
    not return it).

    ``mesh`` (a ``DeviceMesh`` of axes ("data", "model"), from
    ``launch.mesh.host_world``) trains the partitioned LM on it, as the
    reference does on its mesh: every rank of the world calls this with
    the same arguments, draws its data shard of each batch
    (``SyntheticLM.batch_at(step, shard, n_shards)``; a global batch the
    data axes do not divide raises ``ValueError``), and runs the train step
    whose gradients are reduce-scattered onto ZeRO-1 moments (all-reduced
    without ``cfg.zero1``). The weights are one device's from the same
    seed, so the run is the one-device run up to the order of reductions;
    ``loss`` and ``grad_norm`` are the same on every rank, rank 0 prints
    the log lines, the checkpoint records the mesh's ``[dp, tp]`` and
    ``resume`` restores onto this mesh whatever mesh wrote it. ``params``
    and ``opt_state`` are then DTensors, shards on this rank's device."""
    shard, n_shards = mesh_mod.data_shard(mesh)
    if global_batch % n_shards:
        raise ValueError(f"train_loop: global batch {global_batch} does not "
                         f"split over the mesh's {n_shards} data shards")
    if device is not None:
        dev = torch.device(device)
    else:
        dev = resolve_device() if mesh is None else mesh_mod.mesh_device(mesh)
    lm = LM(cfg, dev, mesh=mesh)
    data = SyntheticLM(DataConfig(seed=seed, global_batch=global_batch,
                                  seq_len=seq_len), cfg)
    log = mesh_mod.is_rank0(mesh)
    with lm.sharded():
        start = 0
        if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
            state, manifest = ckpt.restore(
                ckpt_dir, device=dev, mesh=mesh,
                specs=state_specs(lm) if mesh is not None else None)
            lm.load_state_dict(_dotted(state["params"]))
            opt_state = {"m": _dotted(state["opt"]["m"]),
                         "v": _dotted(state["opt"]["v"]),
                         "step": state["opt"]["step"]}
            start = manifest["extra"]["data_cursor"]
            if log:
                print(f"resumed from step {start}")
        else:
            lm.init(torch.Generator(device=dev).manual_seed(seed))
            opt_state = init_opt_state(lm)
        step_fn = make_train_step(lm, adamw.AdamWConfig())

        metrics: Dict[str, Any] = {}
        skipped = 0
        for s in range(start, steps):
            if fail_at is not None and s == fail_at:
                raise RuntimeError(f"injected failure at step {s}")
            batch = _batch(lm, data.batch_at(s, shard, n_shards),
                           global_batch, dev)
            opt_state, metrics = step_fn(opt_state, batch)
            if skip_anomalous_grads and _value(
                    metrics["grad_norm"]) > grad_norm_limit:
                skipped += 1    # counted; the update stays, as in the reference
            if log and log_every and (s % log_every == 0 or s == steps - 1):
                print(f"step {s}: loss={_value(metrics['loss']):.4f} "
                      f"gnorm={_value(metrics['grad_norm']):.3f}")
            if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
                _save(ckpt_dir, s + 1, lm, opt_state, seed, cfg.name)
        final = {k: _value(v) for k, v in metrics.items()}
        final["skipped_steps"] = skipped
        if ckpt_dir and ckpt_every:
            _save(ckpt_dir, steps, lm, opt_state, seed, cfg.name)
    final["params"] = lm.state_dict()
    final["opt_state"] = opt_state
    return final


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-anomalous-grads", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    set_default_device(args.device)
    if mesh_mod.world_env() is None and mesh_mod.host_ranks() > 1:
        # a plain start on a host of several cards: one rank a card
        mesh_mod.launch(main, (sys.argv[1:] if argv is None else argv,))
        return
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    kw = dict(steps=args.steps, global_batch=args.global_batch,
              seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              fail_at=args.fail_at, seed=args.seed,
              skip_anomalous_grads=args.skip_anomalous_grads)
    if mesh_mod.world_env() is None:
        out = train_loop(cfg, **kw)
    else:
        with mesh_mod.host_world() as dm:
            out = train_loop(cfg, mesh=dm, **kw)
            if not mesh_mod.is_rank0(dm):
                return
    out.pop("params", None)
    out.pop("opt_state", None)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
