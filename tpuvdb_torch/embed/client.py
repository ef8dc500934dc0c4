"""Remote ingest/search client with local CLIP embedding: the port of
tpuvdb.embed.client.

The reference system's VectorDBOperation embeds images and text locally
(CLIP on the client) and talks to the coordinator (put_image,
batch_put_images, text_search). This client does the same against a
tpuvdb or tpuvdb_torch HTTP server, embedding on the caller's `device`
(None = cuda; "cpu" to embed on the CPU).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from tpuvdb_torch.api.client import DBClient
from tpuvdb_torch.core.types import VectorData
from tpuvdb_torch.utils.logging import get_logger

logger = get_logger("tpuvdb_torch.embed.client")

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def image_files(directory: str, limit: int = 0) -> List[str]:
    """The images of `directory` by name, the first `limit` (0 = all)."""
    files = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.lower().endswith(IMAGE_EXTS)
    )
    return files[:limit] if limit else files


class VectorDBOperation:
    """Same class name and surface as the reference's client helper."""

    def __init__(self, coord_addr: str = "127.0.0.1:8081", embedder=None,
                 vector_dim: int = 512, device=None):
        self.client = DBClient(coord_addr)
        self.vector_dim = vector_dim
        self.device = device
        self._embedder = embedder

    @property
    def embedder(self):
        if self._embedder is None:
            from tpuvdb_torch.embed.clip import load_default_embedder

            self._embedder = load_default_embedder(self.vector_dim,
                                                   device=self.device)
        return self._embedder

    def _record(self, path: str, vec, dataset: str,
                key: Optional[str] = None) -> VectorData:
        return VectorData(key=key or os.path.basename(path), vector=vec,
                          metadata={"file_path": path, "dataset": dataset,
                                    "dim": str(self.vector_dim)})

    def put_image(self, image_path: str, key: Optional[str] = None,
                  dataset: str = "default") -> Dict:
        vec = self.embedder.image2vec(image_path)
        vd = self._record(image_path, vec, dataset, key)
        r = self.client.call("put", vd.to_dict())
        if not r.get("success") and "capacity" in r.get("message", "").lower():
            # the reference's capacity hint
            logger.warning("put_image failed: shard capacity exceeded — "
                           "compact or raise shard_capacity")
        return r

    def batch_put_images(self, directory: str, dataset: str = "default",
                         limit: int = 0, batch_size: int = 32) -> Dict:
        files = image_files(directory, limit)
        ok = 0
        for start in range(0, len(files), batch_size):
            chunk = files[start : start + batch_size]
            vecs = self.embedder.image2vec_batch(chunk)
            records = [self._record(p, v, dataset).to_dict()
                       for p, v in zip(chunk, vecs)]
            r = self.client.call("put_batch", {"records": records})
            if r.get("success"):
                ok += len(chunk)
            else:
                logger.warning("batch failed at %d: %s", start, r.get("message"))
        return {"success": True, "ingested": ok, "total": len(files)}

    def text_search(self, text: str, top_k: int = 5) -> List[Dict]:
        """Returns [{file_path, score, key, metadata}] ascending by score."""
        qvec = self.embedder.text2vec(text)
        r = self.client.call("search", {
            "query_vector": [float(x) for x in qvec], "top_k": top_k,
        })
        if not r.get("success"):
            return []
        sr = r["search_result"]
        return [
            {"key": k, "score": s,
             "file_path": m.get("file_path", k), "metadata": m}
            for k, s, m in zip(sr["keys"], sr["scores"], sr["metadatas"])
        ]
