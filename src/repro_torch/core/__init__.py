# The similarity self-join of the PyTorch port (GPU-Join of Gowanlock &
# Karsin 2018, adapted per DESIGN.md), mirroring repro.core's names.
from repro_torch.core.types import (  # noqa: F401
    EngineConfig,
    SelfJoinConfig,
    SelfJoinResult,
    SelfJoinStats,
)
from repro_torch.core.selfjoin import self_join, self_join_hostloop  # noqa: F401
from repro_torch.core.engine import QueryPlanTables, SelfJoinEngine  # noqa: F401
from repro_torch.core.snapshot import (  # noqa: F401
    GridSnapshot,
    make_dense_plan,
    resolve_device,
    snapshot_from_numpy,
)
from repro_torch.core.cost import (  # noqa: F401
    TierDecision,
    decide,
    dense_join_cost,
    indexed_join_cost,
)
from repro_torch.core.reorder import variance_reorder, estimate_dim_variance  # noqa: F401
from repro_torch.core.grid import (  # noqa: F401
    GridIndex,
    QueryTilePlan,
    TilePlan,
    build_grid,
    build_query_tile_plan,
    build_tile_plan,
)
from repro_torch.core.tuning import KEstimate, estimate_k_costs, select_k  # noqa: F401
from repro_torch.core.dist_engine import DistributedSelfJoinEngine  # noqa: F401
from repro_torch.core.partition import make_partition, assign_dynamic, simulate_scaling  # noqa: F401
