from tpuvdb_torch.utils.sharding_utils import assign_shards_to_nodes, get_shard_id

__all__ = ["get_shard_id", "assign_shards_to_nodes"]
