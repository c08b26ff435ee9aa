from repro_torch.sharding.rules import (  # noqa: F401
    DEFAULT_RULES,
    AbstractMesh,
    P,
    axis_rules,
    current_mesh,
    logical_spec,
    make_param_sharding,
    param_specs,
    shard_act,
    zero1_extend,
)
