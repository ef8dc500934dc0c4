"""The reference's two examples on the port's API, run with `python -m`:
`quickstart` (the embedded engine with a data_dir) and `sharded_serving`
(the engine over a device mesh)."""
