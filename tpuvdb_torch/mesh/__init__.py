from tpuvdb_torch.mesh.mesh import Mesh, create_mesh, device_count
from tpuvdb_torch.mesh.sharded import sharded_search

__all__ = ["Mesh", "create_mesh", "device_count", "sharded_search"]
