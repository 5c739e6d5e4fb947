"""Map a torch-defined loop body onto a CGRA: the ``torch.fx`` frontend of
the PyTorch port, with the routing-node insertion, on the inner loops of
the assigned LM architectures (``examples/map_jax_loop.py`` does the same
with the JAX package's jaxpr frontend).

    PYTHONPATH=src python examples/map_torch_loop.py [--cgra 4x4] [--device cpu]

``--device`` (``cuda`` by default) is where a racing walk would run; the
default solver here is the host CDCL.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch import set_default_device  # noqa: E402
from repro_torch.core.cgra import cgra_from_name  # noqa: E402
from repro_torch.core.frontend import trace_loop_body  # noqa: E402
from repro_torch.core.mapper import MapperConfig, map_loop  # noqa: E402

# scalar inner-loop bodies representative of the assigned architectures
# (the elementwise loops a CGRA could offload; matmuls are not a modulo-
# scheduling target)


def rope_rotation(i, c, s):
    """RoPE-style fixed-point rotate pair (dense/GQA archs)."""
    x1 = (c * 13 - s * 7) >> 4
    x2 = (c * 7 + s * 13) >> 4
    return (x1, x2)


def router_argmax_step(i, best, bestv, x):
    """MoE router running argmax (llama4 / deepseek)."""
    take = x > bestv
    nb = torch.where(take, i, best)
    nv = torch.where(take, x, bestv)
    return (nb, nv)


def ssd_recurrence(i, state, x):
    """Integer SSD-flavoured state update (mamba2 / hymba)."""
    decayed = state - (state >> 3)
    return (decayed + x * 5,)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cgra", default="4x4")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)
    cgra = cgra_from_name(args.cgra)

    cases = [
        ("rope_rotation", rope_rotation, 2, 0),
        ("router_argmax", router_argmax_step, 2, 1),
        ("ssd_recurrence", ssd_recurrence, 1, 1),
    ]
    print(f"target: {cgra}\n")
    failed = 0
    for name, fn, n_carry, loads in cases:
        g, _ = trace_loop_body(fn, n_carry=n_carry, loads=loads, name=name)
        base = map_loop(g, cgra, MapperConfig(solver="auto", timeout_s=60))
        routed = map_loop(g, cgra, MapperConfig(
            solver="auto", timeout_s=60, routing=True, max_route_nodes=4))
        failed += not (base.success and routed.success)
        print(f"{name:16s} nodes={g.n:2d} MII={base.mii}  "
              f"II(paper-faithful)={base.ii}  II(+routing)={routed.ii}"
              f"{'  <- routing helped' if (routed.ii or 99) < (base.ii or 99) else ''}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
