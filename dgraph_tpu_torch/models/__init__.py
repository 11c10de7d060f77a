"""Port of dgraph_tpu/models (see the package docstring)."""
