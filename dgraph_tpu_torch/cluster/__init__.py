"""Port of dgraph_tpu/cluster: the single-node oracle (see the package docstring)."""
