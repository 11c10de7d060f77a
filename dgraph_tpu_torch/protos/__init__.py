"""Generated protobuf messages of the port (see task.proto). Regenerate
from the repository root with:
protoc --python_out=. dgraph_tpu_torch/protos/task.proto
"""
from dgraph_tpu_torch.protos import task_pb2
