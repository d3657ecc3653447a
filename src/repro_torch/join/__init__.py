# The online similarity query service of the PyTorch port (DESIGN.md #8,
# #10): a persistent device-resident MUTABLE index (build once, save/load
# across restarts and across packages, insert/delete/compact between
# requests) serving batched epsilon range queries and kNN on top of the
# paper's grid join, mirroring repro.join's names.
from repro_torch.join.index import (  # noqa: F401
    IndexView,
    PendingCompact,
    SimilarityIndex,
)
from repro_torch.join.service import (  # noqa: F401
    KnnResult,
    QueryService,
    RangeCountResult,
    RangePairsResult,
    ServiceStats,
)
