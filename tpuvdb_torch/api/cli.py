"""Operator CLI: the port of tpuvdb.api.cli.

    python -m tpuvdb_torch.api.cli [--device cuda|cpu] COMMAND ...

The reference's commands with the same argument shapes (comma-separated
vectors, repeated `k=v` metadata, `--coord-addr host:port`):
`register-node`, `list-nodes`, `put`, `delete`, `get`, `search`, `info`,
`flush`, `compact`, `checkpoint`, `export`, `import`, `serve` and
`coordinate`. `export` and `import` keep the reference's msgpack file
format, so a backup taken by one package loads in the other.

Two modes:
  * remote (default): talks JSON/HTTP to a running `serve` process (of
    either package) at --coord-addr (default 127.0.0.1:8081).
  * embedded: `--data-dir PATH` opens the engine in-process on --device.

`serve` runs on --device (default cuda; "cpu" runs the plain PyTorch
versions of the kernels) and, as the reference, shards over every visible
card (`--mesh`, the default, with more than one card) or splits them into
`--replicas` groups of a 2-D (repl, shards) mesh where the cards divide.
`text-search` and `ingest-images` embed with the CLIP towers
(embed/clip.py) on --device: in-process with --data-dir, else the server
embeds the text and the CLI the images. `bench --suite scan|streaming|clip`
runs bench/scan.py (the headline scan QPS), bench/streaming.py (durable
ingest) or bench/clip_e2e.py (text -> image) on --device.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

import click

from tpuvdb_torch.core.config import DBConfig

_DEVICE_HELP = "device of the engine: cuda (the default) or cpu"


def _parse_vector(s: str) -> List[float]:
    try:
        return [float(x) for x in s.replace(" ", "").split(",") if x != ""]
    except ValueError:
        raise click.BadParameter(f"bad vector literal: {s[:50]}...")


def _parse_metadata(items: Tuple[str, ...]) -> Dict[str, str]:
    md = {}
    for item in items:
        if "=" not in item:
            raise click.BadParameter(f"metadata must be key=value, got: {item}")
        k, v = item.split("=", 1)
        md[k] = v
    return md


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))
    def fmt(row):
        return " | ".join(str(c).ljust(w) for c, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


class Ctx:
    def __init__(self, coord_addr: str, data_dir: Optional[str],
                 device: str = "cuda"):
        self.coord_addr = coord_addr
        self.data_dir = data_dir
        self.device = device
        self._service = None
        self._client = None

    @property
    def embedded(self) -> bool:
        return self.data_dir is not None

    def service(self):
        """The in-process service of embedded mode, opened at first use."""
        if self._service is None:
            from tpuvdb_torch.api.service import DBService

            self._service = DBService(DBConfig(), data_dir=self.data_dir,
                                      device=self.device)
        return self._service

    def call(self, method: str, params: dict) -> dict:
        if self.embedded:
            return self.service().handle(method, params)
        if self._client is None:
            from tpuvdb_torch.api.client import DBClient

            self._client = DBClient(self.coord_addr)
        return self._client.call(method, params)


@click.group()
@click.version_option(version=__import__("tpuvdb_torch").__version__,
                      message="tpuvdb_torch %(version)s")
@click.option("--coord-addr", default="127.0.0.1:8081", show_default=True,
              help="coordinator address (host:port)")
@click.option("--data-dir", default=None,
              help="open the engine in-process at this path instead of RPC")
@click.option("--device", default="cuda", show_default=True,
              help=_DEVICE_HELP)
@click.pass_context
def cli(ctx, coord_addr, data_dir, device):
    """tpuvdb_torch — the tpuvdb vector database in PyTorch on a GPU."""
    ctx.obj = Ctx(coord_addr, data_dir, device)


def _echo_response(r: dict):
    ok = r.get("success")
    color = "green" if ok else "red"
    click.secho(("OK: " if ok else "FAILED: ") + r.get("message", ""), fg=color)
    if not ok:
        sys.exit(1)


@cli.command("register-node")
@click.argument("node_id")
@click.argument("address")
@click.pass_obj
def register_node(ctx: Ctx, node_id, address):
    """Register a data node."""
    _echo_response(ctx.call("register_node", {"node_id": node_id, "address": address}))


@cli.command("list-nodes")
@click.pass_obj
def list_nodes(ctx: Ctx):
    """List registered nodes."""
    r = ctx.call("list_nodes", {})
    if not r.get("success"):
        _echo_response(r)
    rows = [
        [n["node_id"], n["address"],
         "online" if n["online"] else "offline",
         "virtual" if n.get("virtual") else "external"]
        for n in r.get("nodes", [])
    ]
    click.echo(_table(["node_id", "address", "status", "kind"], rows))
    if r.get("shard_map"):
        click.echo("\nshard map:")
        srows = [
            [sid, ",".join(m["master"]), ",".join(m["slaves"])]
            for sid, m in sorted(r["shard_map"].items(), key=lambda kv: int(kv[0]))
        ]
        click.echo(_table(["shard", "master", "slaves"], srows))


@cli.command("put")
@click.argument("key")
@click.argument("vector")
@click.option("--metadata", "-m", multiple=True, help="metadata key=value (repeatable)")
@click.pass_obj
def put(ctx: Ctx, key, vector, metadata):
    """Insert/overwrite a vector."""
    _echo_response(ctx.call("put", {
        "key": key,
        "vector": _parse_vector(vector),
        "metadata": _parse_metadata(metadata),
    }))


@cli.command("delete")
@click.argument("key")
@click.pass_obj
def delete(ctx: Ctx, key):
    """Delete a vector by key."""
    _echo_response(ctx.call("delete", {"key": key}))


@cli.command("get")
@click.argument("key")
@click.option("--full-vector", is_flag=True, help="print the whole vector")
@click.pass_obj
def get(ctx: Ctx, key, full_vector):
    """Fetch a vector by key."""
    r = ctx.call("get", {"key": key})
    if not r.get("success"):
        _echo_response(r)
    vd = r["vector_data"]
    vec = vd["vector"]
    shown = vec if full_vector else vec[:8] + (["..."] if len(vec) > 8 else [])
    click.secho(f"key: {vd['key']}", fg="green")
    click.echo(f"dim: {len(vec)}")
    click.echo(f"vector: {shown}")
    click.echo(f"metadata: {vd['metadata']}")
    click.echo(f"timestamp: {vd['timestamp']}")


@cli.command("search")
@click.argument("vector")
@click.option("--top-k", "-k", default=5, show_default=True)
@click.option("--filter", "-f", "filters", multiple=True,
              help="metadata filter key=value (repeatable)")
@click.option("--threshold", default=0.0, show_default=True,
              help="max squared-L2 distance (0 = off)")
@click.pass_obj
def search(ctx: Ctx, vector, top_k, filters, threshold):
    """K-NN search (with metadata filters and a distance threshold)."""
    r = ctx.call("search", {
        "query_vector": _parse_vector(vector),
        "top_k": top_k,
        "filter_metadata": _parse_metadata(filters),
        "threshold": threshold,
    })
    if not r.get("success"):
        _echo_response(r)
    sr = r["search_result"]
    rows = [
        [i + 1, k, f"{s:.6f}", json.dumps(m)]
        for i, (k, s, m) in enumerate(zip(sr["keys"], sr["scores"], sr["metadatas"]))
    ]
    click.echo(_table(["rank", "key", "score(L2^2)", "metadata"], rows))


@cli.command("info")
@click.pass_obj
def info(ctx: Ctx):
    """Engine statistics."""
    r = ctx.call("info", {})
    click.echo(json.dumps(r.get("info", r), indent=2))


@cli.command("flush")
@click.pass_obj
def flush(ctx: Ctx):
    """Force staged writes into the device index."""
    _echo_response(ctx.call("flush", {}))


@cli.command("compact")
@click.pass_obj
def compact(ctx: Ctx):
    """Rebuild shards densely, dropping soft-deleted slots."""
    _echo_response(ctx.call("compact", {}))


@cli.command("checkpoint")
@click.pass_obj
def checkpoint(ctx: Ctx):
    """Write a checkpoint now."""
    _echo_response(ctx.call("checkpoint", {}))


def serve_mesh(mesh: bool, replicas: int, device: str):
    """The mesh `serve` opens, as the reference's: with --mesh, a 2-D
    (replicas, cards // replicas) mesh where replicas > 1 divide the
    visible cards, else a 1-D mesh over them all; None with one card (or
    on the CPU), where the reference opens none either."""
    import torch

    if not mesh or torch.device(device).type != "cuda":
        return None
    from tpuvdb_torch.mesh.mesh import create_mesh, device_count
    from tpuvdb_torch.mesh.replicated import create_mesh_2d

    ndev = device_count()
    if replicas > 1 and ndev % replicas == 0:
        return create_mesh_2d(replicas, ndev // replicas)
    if ndev > 1:
        return create_mesh()
    return None


@cli.command("serve")
@click.option("--host", default="127.0.0.1", show_default=True)
@click.option("--port", default=8081, show_default=True)
@click.option("--data-dir", "serve_data_dir", default=None,
              help="durable storage path (WAL + checkpoints)")
@click.option("--image-root", default=None,
              help="root dir for /static image serving")
@click.option("--mesh/--no-mesh", default=True,
              help="shard across all visible cards")
@click.option("--replicas", default=1, show_default=True,
              help="replica groups on a 2-D (repl, shards) mesh: each group "
                   "holds a full corpus copy and serves a slice of every "
                   "query batch")
@click.option("--device", "serve_device", default="cuda", show_default=True,
              help=_DEVICE_HELP)
def serve(host, port, serve_data_dir, image_root, mesh, replicas,
          serve_device):
    """Start the database server (coordinator + data plane + HTTP API)."""
    import signal

    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.api.service import DBService

    service = DBService(DBConfig(), data_dir=serve_data_dir,
                        mesh=serve_mesh(mesh, replicas, serve_device),
                        image_root=image_root, device=serve_device)
    service.registry.start_health_loop()
    server = DBServer(service, host=host, port=port)
    click.secho(f"tpuvdb_torch serving on http://{server.address}",
                fg="green")

    # graceful SIGTERM: close the service (a final checkpoint)
    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()


@cli.command("ingest-images")
@click.argument("directory")
@click.option("--dataset", default="default", show_default=True)
@click.option("--limit", default=0, help="max images (0 = all)")
@click.pass_obj
def ingest_images(ctx: Ctx, directory, dataset, limit):
    """Embed and ingest a directory of images (the reference's
    batch_put_images)."""
    if ctx.embedded:
        from tpuvdb_torch.embed.client import image_files

        files = image_files(directory, limit)
        svc = ctx.service()
        ok = 0
        with click.progressbar(files, label="ingesting") as bar:
            for f in bar:
                r = svc.put_image(f, dataset=dataset)
                ok += bool(r.get("success"))
        click.secho(f"ingested {ok}/{len(files)} images", fg="green")
    else:
        # remote: embed here, at the configured width, and ship the
        # vectors to the server
        from tpuvdb_torch.embed.client import VectorDBOperation

        op = VectorDBOperation(ctx.coord_addr,
                               vector_dim=DBConfig().vector_dim,
                               device=ctx.device)
        out = op.batch_put_images(directory, dataset=dataset, limit=limit)
        click.secho(f"ingested {out['ingested']}/{out['total']} images",
                    fg="green")


@cli.command("export")
@click.argument("out_path")
@click.option("--page", default=2000, show_default=True)
@click.pass_obj
def export(ctx: Ctx, out_path, page):
    """Dump every record (key, vector, metadata, ts) to a msgpack file —
    a portable backup independent of checkpoints/WAL."""
    import msgpack

    from tpuvdb_torch.core import wire

    n = 0
    cursor = 0
    with open(out_path, "wb") as f:
        # wire._default packs ndarray vectors as raw f32 ExtType — local
        # exports hand back ndarrays and the backup stays 4-5x smaller
        # than float-list msgpack
        packer = msgpack.Packer(use_bin_type=True, default=wire._default)
        while cursor >= 0:
            r = ctx.call("export", {"cursor": cursor, "limit": page})
            if not r.get("success"):
                _echo_response(r)
            for rec in r.get("records", []):
                f.write(packer.pack(rec))
                n += 1
            cursor = r.get("cursor", -1)
    click.secho(f"exported {n} records to {out_path}", fg="green")


@cli.command("import")
@click.argument("in_path")
@click.option("--batch", default=512, show_default=True)
@click.pass_obj
def import_(ctx: Ctx, in_path, batch):
    """Load records from a msgpack export file."""
    import msgpack

    n = 0
    pending = []

    def flush_batch():
        nonlocal n
        if not pending:
            return
        r = ctx.call("put_batch", {"records": list(pending)})
        if not r.get("success"):
            _echo_response(r)
        n += len(pending)
        pending.clear()

    from tpuvdb_torch.core import wire

    with open(in_path, "rb") as f:
        # ext_hook restores raw-f32 vectors from new-format backups; old
        # float-list dumps unpack unchanged
        for rec in msgpack.Unpacker(f, raw=False, ext_hook=wire._ext_hook):
            pending.append(rec)
            if len(pending) >= batch:
                flush_batch()
        flush_batch()
    click.secho(f"imported {n} records", fg="green")


@cli.command("coordinate")
@click.option("--host", default="127.0.0.1", show_default=True)
@click.option("--port", default=8081, show_default=True)
@click.option("--data-dir", default=None,
              help="persist the node registry + shard map here so a "
                   "coordinator restart resumes routing without "
                   "re-registration")
@click.pass_obj
def coordinate(ctx: Ctx, host, port, data_dir):
    """Start a federated coordinator (multi-host mode): routes puts by
    shard hash and fans searches out to registered `serve` nodes (of
    either package) in parallel."""
    import signal

    from tpuvdb_torch.api.server import DBServer
    from tpuvdb_torch.cluster.federation import FederatedCoordinator

    # text search embeds at the coordinator, on --device
    coord = FederatedCoordinator(DBConfig(data_dir=data_dir),
                                 device=ctx.device)
    coord.registry.start_health_loop()
    server = DBServer(coord, host=host, port=port)
    click.secho(f"tpuvdb_torch coordinator on http://{server.address}",
                fg="green")

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        coord.close()


@cli.command("bench")
@click.option("--suite", type=click.Choice(["scan", "streaming", "clip"]),
              default="scan", show_default=True)
@click.pass_obj
def bench(ctx: Ctx, suite):
    """Run a benchmark suite on --device: scan (the kernels' paths and the
    served engines at 1M x 128; one JSON line a stage), streaming (durable
    ingest beside searches, then recovery) or clip (text -> image). The
    last line of stdout is the result, with the reference's keys."""
    from tpuvdb_torch.bench import clip_e2e, scan, streaming

    suites = {"scan": scan, "streaming": streaming, "clip": clip_e2e}
    suites[suite].main(device=ctx.device)


@cli.command("text-search")
@click.argument("text")
@click.option("--top-k", "-k", default=5, show_default=True)
@click.pass_obj
def text_search(ctx: Ctx, text, top_k):
    """Text -> image search via the CLIP text tower (the reference's
    text_search)."""
    if ctx.embedded:
        out = ctx.service().text_search(text, top_k)
    else:
        from tpuvdb_torch.api.client import DBClient

        out = DBClient(ctx.coord_addr).api_search(text, top_k)
        if "error" in out:
            raise click.ClickException(f"text-search: {out['error']}")
    rows = [
        [i + 1, r["key"], f"{r['score']:.6f}", r["file_path"]]
        for i, r in enumerate(out.get("results", []))
    ]
    click.echo(_table(["rank", "key", "score", "file_path"], rows))


def main():
    cli()


if __name__ == "__main__":
    main()
