"""The mapper portfolio on the GPU: solve a batch of loop-mapping problems
with the port's probSAT walk on the card (``walk_chunk``) and the complete
CDCL solver as the fallback, as ``examples/portfolio_mapper.py`` does with
the JAX package's chains.

    PYTHONPATH=src python examples/portfolio_mapper_torch.py [--device cpu]

Slow by design: the portfolio walks its full budget on every UNSAT II
before the CDCL fallback proves it, about a minute a kernel.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import set_default_device  # noqa: E402
from repro_torch.core import suite  # noqa: E402
from repro_torch.core.cgra import CGRA  # noqa: E402
from repro_torch.core.encode import EncoderSession  # noqa: E402
from repro_torch.core.sat import SAT, solve  # noqa: E402
from repro_torch.core.schedule import min_ii  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)

    cgra = CGRA(3, 3)
    jobs = ["srand", "bitcount", "gsm", "nw"]
    print(f"portfolio-mapping {len(jobs)} kernels on {cgra}\n")
    for name in jobs:
        g = suite.get(name)
        session = EncoderSession(g, cgra)
        ii = min_ii(g, cgra)
        while True:
            enc = session.encode(ii)
            t0 = time.time()
            status, model = solve(enc.cnf, "portfolio", seed=ii)
            dt = time.time() - t0
            if status == SAT:
                print(f"{name:10s} II={ii:2d} vars={enc.cnf.n_vars:5d} "
                      f"clauses={enc.cnf.n_clauses:6d} ({dt:.2f}s)")
                break
            ii += 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
