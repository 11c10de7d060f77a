"""Port of dgraph_tpu/store (see the package docstring)."""
