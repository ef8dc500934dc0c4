"""The share of the IVF index's searches that replayed a CUDA graph of the
probe (tpuvdb_torch/index/probe_graphs.py): `ivf_graph_replays` over every
search the index counted (the replays and the `ivf_graph_eager_<reason>`
calls), over the whole run, warm-up included. Logged beside it: the
captures and the eager calls by reason. None where the engine counts no
probe graphs (a program without them) or the index counted no search."""


def read(run):
    stats = run.info.get("stats", {})
    if "ivf_graph_replays" not in stats:
        return None
    replays = stats["ivf_graph_replays"]
    eager = {name[len("ivf_graph_eager_"):]: n for name, n in stats.items()
             if name.startswith("ivf_graph_eager_")}
    searches = replays + sum(eager.values())
    if not searches:
        return None
    run.log(f"ivf probe graphs: {replays} replays of {searches} index "
            f"searches, {stats.get('ivf_graph_captures', 0)} captures; "
            f"eager {eager} (whole run)")
    return replays / searches
