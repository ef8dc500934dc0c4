"""The engine's `search.keys` span (engine/engine.py `_assemble_results`):
the engine lock, key resolution in the doc store (`keys_rows`, or the slow
path's liveness and `keys_at_bulk`) and the lists of keys, in ms a call of
the traced window. Logged beside it, from the engine's counters over the
whole run (warm-up included): the query rows a call (`search_queries` /
`searches`), the span's us a query row, and the calls that took the slow
path (`search_slow_path`), which tells `keys_rows` from `keys_at_bulk`."""

from perfbench.spans import per_call_ms


def read(run):
    ms = per_call_ms(run, ["search.keys"])
    if ms is None:
        return None
    stats = run.info.get("stats", {})
    calls, rows = stats.get("searches"), stats.get("search_queries")
    if calls and rows and "search_slow_path" in stats:
        run.log(f"search.keys {ms:.4f} ms a call, "
                f"{ms * 1e3 * calls / rows:.4f} us a query row at "
                f"{rows / calls:.2f} rows a call; slow path "
                f"{stats['search_slow_path']} of {calls} calls (whole run)")
    return ms
