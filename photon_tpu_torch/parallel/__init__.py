"""Multiple devices over torch.distributed ranks (port of photon_tpu/parallel)."""

from photon_tpu_torch.parallel.mesh import make_mesh, DATA_AXIS, ENTITY_AXIS, FEATURE_AXIS  # noqa: F401
from photon_tpu_torch.parallel.distributed import shard_batch, replicate  # noqa: F401
from photon_tpu_torch.parallel.feature_sharded import (  # noqa: F401
    padded_dim,
    place_feature_sharded,
    sparse_value_and_grad_feature_sharded,
    train_fixed_effect_feature_sharded,
)
from photon_tpu_torch.parallel.entity_shard import (  # noqa: F401
    DEFAULT_N_SHARDS,
    EntityShardPlan,
    build_shard_plan,
    merge_shard_coefficients,
    shard_members,
)
