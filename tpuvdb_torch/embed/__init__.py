from tpuvdb_torch.embed.clip import CLIPConfig, CLIPEmbedder, load_default_embedder

__all__ = ["CLIPEmbedder", "CLIPConfig", "load_default_embedder"]
