"""The paper's primary contribution: hybrid (topology+data-driven) worklist
scheduling with a persistent worklist, applied to IPGC and to the other
registered colorers (``repro/core``); the paper's baselines; hybrid BFS."""
from repro_torch.core.engine import (ColoringResult, color,  # noqa: F401
                                     color_outlined, color_outlined_hybrid,
                                     outlined, set_outline_default)
from repro_torch.core.worklist import (Worklist, bucket_capacities,  # noqa: F401
                                       full_worklist)
from repro_torch.core.verify import (InvalidColoringError,  # noqa: F401
                                     coloring_stats, verify_coloring)
from repro_torch.core import ipgc  # noqa: F401
from repro_torch.core.ipgc import prepare  # noqa: F401
from repro_torch.core.baselines import jpl_color, vb_color  # noqa: F401
from repro_torch.core.distributed import color_distributed  # noqa: F401
