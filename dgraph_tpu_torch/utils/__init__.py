"""Port of dgraph_tpu/utils (see the package docstring)."""
