"""The served path: service, HTTP server and client, CLI. `DBService` is
imported at first use, so a CLI client process (`put`, `search`, `get`)
never imports torch."""

__all__ = ["DBService"]


def __getattr__(name):
    if name == "DBService":
        from tpuvdb_torch.api.service import DBService

        return DBService
    raise AttributeError(f"module 'tpuvdb_torch.api' has no attribute "
                         f"{name!r}")
