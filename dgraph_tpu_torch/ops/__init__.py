"""Port of dgraph_tpu/ops (see the package docstring)."""
