from tpuvdb_torch.cluster.membership import NodeInfo, NodeRegistry

__all__ = ["NodeRegistry", "NodeInfo"]
