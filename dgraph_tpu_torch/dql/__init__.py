"""Port of dgraph_tpu/dql (see the package docstring)."""
