"""End-to-end training loop with checkpoint/restart fault tolerance (a
copy of the JAX package's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch minitron_8b \\
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 10 --device cpu

Fault tolerance model, as in the reference:
  * checkpoints are atomic (see ``repro_torch.checkpoint``) and in the
    reference's format, so either package resumes the other's;
  * --resume restarts from the newest complete checkpoint, bitwise-exact,
    because the data pipeline is stateless in step;
  * --fail-at simulates a hard crash mid-run;
  * --skip-anomalous-grads counts steps whose global grad-norm exceeds the
    limit. Like the reference (``src/repro/launch/train.py``, whose two
    branches both adopt the step's update), it still keeps their update,
    so that a run equals the reference's.

Runs on ``--device`` (cuda unless told otherwise); nothing falls back to
the CPU. On one card the checkpoint's ``mesh`` is ``[1, 1]``.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint import checkpoint as ckpt
from ..configs import get_config
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import resolve_device, set_default_device
from ..models.model import LM
from ..optim import adamw
from .steps import make_train_step


def _tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"blocks.attn.wq": t} -> {"blocks": {"attn": {"wq": t}}}."""
    return ckpt._unflatten({k.replace(".", "/"): v for k, v in flat.items()})


def _dotted(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k.replace("/", "."): v for k, v in ckpt._flatten(tree).items()}


def _save(ckpt_dir: str, step: int, lm: LM, opt_state: Dict[str, Any],
          seed: int, arch: str) -> None:
    ckpt.save(ckpt_dir, step,
              {"params": _tree(lm.state_dict()),
               "opt": {"m": _tree(opt_state["m"]), "v": _tree(opt_state["v"]),
                       "step": opt_state["step"]}},
              extra={"data_cursor": step, "seed": seed, "arch": arch,
                     "mesh": [1, 1]})


def train_loop(cfg, *, steps: int = 20, global_batch: int = 8,
               seq_len: int = 64, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 0, resume: bool = False,
               fail_at: Optional[int] = None, seed: int = 0,
               skip_anomalous_grads: bool = False,
               grad_norm_limit: float = 1e3, device=None,
               log_every: int = 5) -> Dict[str, Any]:
    """Train ``cfg`` from seeded weights (or resume from ``ckpt_dir``) for
    ``steps`` steps of ``SyntheticLM(seed)``. Returns the last step's
    metrics as floats, ``skipped_steps``, ``params`` (the LM's state dict,
    on ``device``) and ``opt_state`` (the AdamW state; the reference does
    not return it)."""
    dev = torch.device(device) if device is not None else resolve_device()
    lm = LM(cfg, dev)
    data = SyntheticLM(DataConfig(seed=seed, global_batch=global_batch,
                                  seq_len=seq_len), cfg)
    start = 0
    if resume and ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, manifest = ckpt.restore(ckpt_dir, device=dev)
        lm.load_state_dict(_dotted(state["params"]))
        opt_state = {"m": _dotted(state["opt"]["m"]),
                     "v": _dotted(state["opt"]["v"]),
                     "step": state["opt"]["step"]}
        start = manifest["extra"]["data_cursor"]
        print(f"resumed from step {start}")
    else:
        lm.init(torch.Generator(device=dev).manual_seed(seed))
        opt_state = adamw.init(dict(lm.named_parameters()))
    step_fn = make_train_step(lm, adamw.AdamWConfig())

    metrics: Dict[str, Any] = {}
    skipped = 0
    for s in range(start, steps):
        if fail_at is not None and s == fail_at:
            raise RuntimeError(f"injected failure at step {s}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(s).items()}
        opt_state, metrics = step_fn(opt_state, batch)
        if skip_anomalous_grads and float(
                metrics["grad_norm"]) > grad_norm_limit:
            skipped += 1    # counted; the update stays, as in the reference
        if log_every and (s % log_every == 0 or s == steps - 1):
            print(f"step {s}: loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if ckpt_dir and ckpt_every and (s + 1) % ckpt_every == 0:
            _save(ckpt_dir, s + 1, lm, opt_state, seed, cfg.name)
    final = {k: float(v) for k, v in metrics.items()}
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
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    out = train_loop(cfg, steps=args.steps, global_batch=args.global_batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, resume=args.resume,
                     fail_at=args.fail_at, seed=args.seed,
                     skip_anomalous_grads=args.skip_anomalous_grads)
    out.pop("params", None)
    out.pop("opt_state", None)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
