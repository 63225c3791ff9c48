"""Graph substrate of the port: the staged construction pipeline
(ingest -> reorder -> layout plan -> assembly, DESIGN.md §8), CSR/ELL/COO
structures, the dataset registry and the partitioning of the distributed
Pipe with the boundary sets of its packed exchange. Host-side numpy, a
copy of ``repro.graphs`` (minus sampling)."""
from repro_torch.graphs.csr import (  # noqa: F401
    Graph,
    GraphArrays,
    build_graph,
    NO_COLOR,
    PAD_COLOR,
)
from repro_torch.graphs.ingest import EdgeList  # noqa: F401
from repro_torch.graphs.layout import LAYOUT_KINDS, LayoutPlan, plan_layout  # noqa: F401
from repro_torch.graphs.transform import REORDERINGS, Permutation  # noqa: F401
from repro_torch.graphs.generators import SUITE_SPECS  # noqa: F401
from repro_torch.graphs.registry import (  # noqa: F401
    clear_dataset_cache,
    dataset_names,
    get_dataset,
    get_dataset_batch,
    heavy_tail_requests,
    register_dataset,
)
