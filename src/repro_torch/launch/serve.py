"""The batched LM decode driver of the port (the LM half of the JAX
package's ``launch/serve.py``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \\
        --smoke --batch 4 --steps 16 --device cpu

Prompts go through ``LM.prefill_with_cache`` (prefill attention on the
flash kernel when the config says ``attn_impl="flash"``), then a greedy
loop of ``LM.decode_step`` over the ring-buffer cache. :func:`serve_lm` is
the driver that ``main`` and ``chip_smoke.py`` both call. Unlike the
reference, whose ``--smoke`` flag cannot be turned off, ``main`` serves
the published widths unless ``--smoke`` is given. The mapping front door
(``CompileFrontDoor``) and ``--offload-cgra`` are not ported yet and
raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import List, Optional

import torch

from .. import device as device_mod
from ..configs import get_config
from ..models.model import LM


@dataclass
class ServeResult:
    fed: torch.Tensor            # [B, steps] the token fed at each step
    tokens: torch.Tensor         # [B, steps] the greedy token after each step
    logits: List[torch.Tensor]   # prefill's last logits, then each step's
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_lm(lm: LM, prompts: torch.Tensor, steps: int, *,
             window: Optional[int] = None,
             feed: Optional[torch.Tensor] = None) -> ServeResult:
    """Prefill ``prompts`` [B, S] (token ids on the LM's device) into a
    ring buffer of ``window`` slots (default ``min(S, attn_window)``, or S
    without a window), then decode ``steps`` tokens greedily from
    t = S. ``feed`` [B, steps], when given, is fed instead of the greedy
    tokens (to hold two runs to the same inputs). Each logits tensor is
    [B, 1, Vp] f32; the times end in a device synchronize."""
    vocab = lm.cfg.vocab
    b, s = prompts.shape
    _sync(lm.device)
    t0 = time.perf_counter()
    lg, cache = lm.prefill_with_cache(prompts, window=window)
    _sync(lm.device)
    prefill_s = time.perf_counter() - t0
    logits = [lg]
    tok = torch.argmax(lg[:, :, :vocab], dim=-1)
    fed, outs = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        x = feed[:, i:i + 1] if feed is not None else tok
        fed.append(x[:, 0])
        lg, cache = lm.decode_step(cache, x, s + i)
        tok = torch.argmax(lg[:, :, :vocab], dim=-1)
        logits.append(lg)
        outs.append(tok[:, 0])
    _sync(lm.device)
    decode_s = time.perf_counter() - t0
    empty = torch.empty((b, 0), dtype=torch.long, device=lm.device)
    return ServeResult(
        fed=torch.stack(fed, dim=1) if fed else empty,
        tokens=torch.stack(outs, dim=1) if outs else empty,
        logits=logits, prefill_s=prefill_s, decode_s=decode_s)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="musicgen_large")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family config (default: "
                         "the published widths)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--window", type=int, default=64)
    ap.add_argument("--offload-cgra", default=None, metavar="RxC",
                    help="not ported yet (raises NotImplementedError)")
    ap.add_argument("--offload-guide", default=None, metavar="NAME_OR_NPZ",
                    help="not ported yet (raises NotImplementedError)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.offload_cgra or args.offload_guide:
        raise NotImplementedError("--offload-cgra/--offload-guide: the "
                                  "mapping service is not ported yet")
    if args.device is not None:
        device_mod.set_default_device(args.device)
    dev = device_mod.resolve_device()
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    lm = LM(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    prompt_len = 8
    prompts = torch.randint(0, cfg.vocab, (args.batch, prompt_len),
                            generator=torch.Generator(device=dev).manual_seed(1),
                            device=dev)
    res = serve_lm(lm, prompts, args.steps, window=args.window)
    dt = res.decode_s
    print(f"decoded {args.steps} tokens x {args.batch} requests "
          f"in {dt:.2f}s ({args.batch*args.steps/dt:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  req{b}: {res.tokens[b, :12].tolist()}...")


if __name__ == "__main__":
    main()
