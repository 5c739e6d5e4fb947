"""Quickstart with the PyTorch port: map a loop onto a CGRA with SAT-MapIt
(the paper pipeline), as ``examples/quickstart.py`` does with the JAX
package.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Builds the paper's running example DFG (Fig. 2a), walks the Fig. 3 loop
(KMS -> CNF -> SAT -> register allocation), prints the mapping as
prolog/kernel/epilog tables, and verifies it against sequential execution.
``--device`` (``cuda`` by default) is where a racing walk would run; the
default solver here is the host CDCL.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch import set_default_device  # noqa: E402
from repro_torch.core.cgra import CGRA  # noqa: E402
from repro_torch.core.dfg import running_example  # noqa: E402
from repro_torch.core.mapper import MapperConfig, map_loop  # noqa: E402
from repro_torch.core.schedule import asap_alap, mobility_schedule  # noqa: E402
from repro_torch.core.simulator import emit_code, verify_mapping  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    set_default_device(args.device)

    g = running_example()
    cgra = CGRA(2, 2, n_regs=4)
    print(f"DFG: {g.n} nodes, {len(g.edges())} edges on {cgra}")

    asap, alap, L = asap_alap(g)
    print(f"critical path {L}; mobility schedule:")
    for t, row in enumerate(mobility_schedule(g)):
        print(f"  t{t}: {[g.nodes[n].name for n in row]}")

    r = map_loop(g, cgra, MapperConfig(solver="auto"))
    if not r.success:
        print("no mapping found", file=sys.stderr)
        return 1
    print(f"\nmapped at II={r.ii} (MII={r.mii}) in {r.total_time:.2f}s; "
          f"attempts: {[(a.ii, a.status) for a in r.attempts]}")
    print(f"register pressure: {r.regalloc.max_pressure} "
          f"(of {cgra.n_regs}); {len(r.regalloc.bypass)} output-reg bypasses")

    code = emit_code(g, cgra, r.placement, r.ii)
    print("\n" + code.render(g))

    chk = verify_mapping(g, cgra, r.placement, r.ii, n_iters=10)
    print(f"\nsimulator verification over 10 iterations: "
          f"{'OK' if chk.ok else chk.errors}")
    return 0 if chk.ok else 1


if __name__ == "__main__":
    sys.exit(main())
