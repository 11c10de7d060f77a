"""Port of dgraph_tpu/server: the single-node Alpha (see the package docstring)."""
