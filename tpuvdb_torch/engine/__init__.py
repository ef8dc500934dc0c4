from tpuvdb_torch.engine.engine import VectorDBEngine

__all__ = ["VectorDBEngine"]
