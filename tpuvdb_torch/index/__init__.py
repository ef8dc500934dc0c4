from tpuvdb_torch.index.layout import ShardMirror, StackedLayout
from tpuvdb_torch.index.exact import DeviceExactIndex
from tpuvdb_torch.index.ivf import IVFIndex

__all__ = ["ShardMirror", "StackedLayout", "DeviceExactIndex", "IVFIndex"]
