"""Port of dgraph_tpu/loader: mutation parsing and xid assignment."""
