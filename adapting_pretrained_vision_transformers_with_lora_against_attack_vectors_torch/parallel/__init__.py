from .mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    MeshSpec,
    batch_sharding,
    gather_tree,
    make_mesh,
    replicated,
    shard_batch,
    shard_tree,
    tree_shardings,
    vit_param_rules,
)
