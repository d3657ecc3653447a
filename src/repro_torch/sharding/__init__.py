from repro_torch.sharding.rules import (  # noqa: F401
    param_specs,
    cache_specs,
    batch_spec,
    dp_axes,
    distribute,
    to_placements,
    PartitionSpec,
    ShapeMesh,
    NamedSharding,
    named_shardings,
)
