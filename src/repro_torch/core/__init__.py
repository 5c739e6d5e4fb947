# The paper's primary contribution — the SAT-based modulo-scheduling
# mapper — lives in this package. Public API, one front door:
#
#   arch()/ArchSpec          declarative fabrics (repro_torch.core.arch)
#   MapRequest -> compile()  the unified mapping request pipeline
#   CGRA/cgra_from_name      legacy homogeneous front end (thin adapter)
#   map_loop/MapperConfig    paper-faithful engine entry points
#
# `compile` shadows the builtin inside this namespace only; import it
# explicitly (`from repro_torch.core import compile`) or use the api module.
from .arch import ArchSpec, arch, op_class                    # noqa: F401
from .cgra import CGRA, cgra_from_name                        # noqa: F401
from .api import MapRequest, compile                          # noqa: F401
from .mapper import MapperConfig, MappingResult, map_loop     # noqa: F401
from .schedule import Infeasible                              # noqa: F401
