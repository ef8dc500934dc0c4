from tpuvdb_torch.utils.sharding_utils import assign_shards_to_nodes, get_shard_id
from tpuvdb_torch.utils.vector_utils import as_f32_matrix, l2_normalize

__all__ = [
    "get_shard_id",
    "assign_shards_to_nodes",
    "as_f32_matrix",
    "l2_normalize",
]
