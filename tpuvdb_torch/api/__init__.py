from tpuvdb_torch.api.service import DBService

__all__ = ["DBService"]
