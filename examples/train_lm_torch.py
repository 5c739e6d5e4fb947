"""End-to-end example of the PyTorch port: train a reduced-config LM with
checkpointing, crash recovery and loss tracking, through the same
``train_loop`` as ``repro_torch.launch.train`` (``examples/train_lm.py``
does this with the JAX package).

    PYTHONPATH=src python examples/train_lm_torch.py --arch minitron_8b \
        --steps 200 [--device cpu] [--ckpt-dir DIR]

Without ``--ckpt-dir`` the checkpoints go to a temporary directory that is
removed at the end; with it, a second run resumes from the newest one.
"""
import argparse
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import set_default_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import train_loop  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="minitron_8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)

    cfg = get_config(args.arch).smoke()
    print(f"training {cfg.name} ({cfg.family}) for {args.steps} steps "
          f"on {args.device}")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        out = train_loop(cfg, steps=args.steps, global_batch=8, seq_len=64,
                         ckpt_dir=args.ckpt_dir or tmp, ckpt_every=50,
                         resume=True, log_every=20)
    out.pop("params", None)
    out.pop("opt_state", None)
    print({k: round(float(v), 4) for k, v in out.items()})
    return 0 if math.isfinite(out["loss"]) else 1


if __name__ == "__main__":
    sys.exit(main())
