# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: dgraph_tpu_torch/protos/task.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"dgraph_tpu_torch/protos/task.proto\x12\x10\x64graph_tpu_torch\"\x17\n\x07UidList\x12\x0c\n\x04uids\x18\x01 \x03(\x06\"\xbb\x01\n\tTaskQuery\x12\x0c\n\x04\x61ttr\x18\x01 \x01(\t\x12\x0f\n\x07reverse\x18\x02 \x01(\x08\x12+\n\x08\x66rontier\x18\x03 \x01(\x0b\x32\x19.dgraph_tpu_torch.UidList\x12\x11\n\tfunc_name\x18\x04 \x01(\t\x12\x11\n\tfunc_args\x18\x05 \x03(\t\x12\x0c\n\x04lang\x18\x06 \x01(\t\x12\x0f\n\x07read_ts\x18\x07 \x01(\x04\x12\r\n\x05\x66irst\x18\x08 \x01(\x05\x12\x0e\n\x06offset\x18\t \x01(\x05\"4\n\tUidMatrix\x12\'\n\x04rows\x18\x01 \x03(\x0b\x32\x19.dgraph_tpu_torch.UidList\"{\n\nTaskResult\x12+\n\x06matrix\x18\x01 \x01(\x0b\x32\x1b.dgraph_tpu_torch.UidMatrix\x12\'\n\x04\x66lat\x18\x02 \x01(\x0b\x32\x19.dgraph_tpu_torch.UidList\x12\x17\n\x0f\x65\x64ges_traversed\x18\x03 \x01(\x04\"B\n\nTxnContext\x12\x10\n\x08start_ts\x18\x01 \x01(\x04\x12\x11\n\tcommit_ts\x18\x02 \x01(\x04\x12\x0f\n\x07\x61\x62orted\x18\x03 \x01(\x08\"\x8a\x01\n\x07Request\x12\r\n\x05query\x18\x01 \x01(\t\x12\x31\n\x04vars\x18\x02 \x03(\x0b\x32#.dgraph_tpu_torch.Request.VarsEntry\x12\x10\n\x08start_ts\x18\x03 \x01(\x04\x1a+\n\tVarsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"W\n\x08Response\x12\x0c\n\x04json\x18\x01 \x01(\x0c\x12)\n\x03txn\x18\x02 \x01(\x0b\x32\x1c.dgraph_tpu_torch.TxnContext\x12\x12\n\nlatency_us\x18\x03 \x01(\x04\"\x7f\n\x0bMutationReq\x12\x12\n\nset_nquads\x18\x01 \x01(\t\x12\x12\n\ndel_nquads\x18\x02 \x01(\t\x12\x10\n\x08set_json\x18\x03 \x01(\t\x12\x10\n\x08\x64\x65l_json\x18\x04 \x01(\t\x12\x12\n\ncommit_now\x18\x05 \x01(\x08\x12\x10\n\x08start_ts\x18\x06 \x01(\x04\"\x9e\x01\n\x0cMutationResp\x12\x36\n\x04uids\x18\x01 \x03(\x0b\x32(.dgraph_tpu_torch.MutationResp.UidsEntry\x12)\n\x03txn\x18\x02 \x01(\x0b\x32\x1c.dgraph_tpu_torch.TxnContext\x1a+\n\tUidsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"@\n\tOperation\x12\x0e\n\x06schema\x18\x01 \x01(\t\x12\x10\n\x08\x64rop_all\x18\x02 \x01(\x08\x12\x11\n\tdrop_attr\x18\x03 \x01(\t\"\x1c\n\rAssignRequest\x12\x0b\n\x03num\x18\x01 \x01(\x04\"/\n\x0b\x41ssignedIds\x12\x10\n\x08start_id\x18\x01 \x01(\x04\x12\x0e\n\x06\x65nd_id\x18\x02 \x01(\x04\"\x17\n\x07Payload\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\"N\n\x0e\x43onnectRequest\x12\x0c\n\x04\x61\x64\x64r\x18\x01 \x01(\t\x12\r\n\x05group\x18\x02 \x01(\x04\x12\x0e\n\x06max_ts\x18\x03 \x01(\x04\x12\x0f\n\x07max_uid\x18\x04 \x01(\x04\"4\n\x0f\x43onnectResponse\x12\x0f\n\x07node_id\x18\x01 \x01(\x04\x12\x10\n\x08group_id\x18\x02 \x01(\x04\"y\n\x05Group\x12\x31\n\x05nodes\x18\x01 \x03(\x0b\x32\".dgraph_tpu_torch.Group.NodesEntry\x12\x0f\n\x07tablets\x18\x02 \x03(\t\x1a,\n\nNodesEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xb7\x01\n\x0fMembershipState\x12=\n\x06groups\x18\x01 \x03(\x0b\x32-.dgraph_tpu_torch.MembershipState.GroupsEntry\x12\x0f\n\x07\x63ounter\x18\x02 \x01(\x04\x12\x0c\n\x04\x64\x65\x61\x64\x18\x03 \x03(\x04\x1a\x46\n\x0bGroupsEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12&\n\x05value\x18\x02 \x01(\x0b\x32\x17.dgraph_tpu_torch.Group:\x02\x38\x01\"O\n\x0cHeartbeatMsg\x12\x0f\n\x07node_id\x18\x01 \x01(\x04\x12\r\n\x05group\x18\x02 \x01(\x04\x12\x0e\n\x06max_ts\x18\x03 \x01(\x04\x12\x0f\n\x07max_uid\x18\x04 \x01(\x04\"1\n\x12JournalTailRequest\x12\r\n\x05since\x18\x01 \x01(\x04\x12\x0c\n\x04peek\x18\x02 \x01(\x08\"O\n\x0bJournalDocs\x12\x11\n\tdocs_json\x18\x01 \x03(\t\x12\x0c\n\x04next\x18\x02 \x01(\x04\x12\x0f\n\x07standby\x18\x03 \x01(\x08\x12\x0e\n\x06log_id\x18\x04 \x01(\t\",\n\rTabletRequest\x12\x0c\n\x04pred\x18\x01 \x01(\t\x12\r\n\x05group\x18\x02 \x01(\x04\"%\n\x06Tablet\x12\x0c\n\x04pred\x18\x01 \x01(\t\x12\r\n\x05group\x18\x02 \x01(\x04\"+\n\tTsRequest\x12\x0b\n\x03num\x18\x01 \x01(\x04\x12\x11\n\tread_only\x18\x02 \x01(\x08\">\n\rCommitRequest\x12\x10\n\x08start_ts\x18\x01 \x01(\x04\x12\x0c\n\x04keys\x18\x02 \x03(\t\x12\r\n\x05\x61\x62ort\x18\x03 \x01(\x08\"\x07\n\x05\x45mpty\"\x83\x01\n\x0bTabletSizes\x12\r\n\x05group\x18\x01 \x01(\x04\x12\x37\n\x05sizes\x18\x02 \x03(\x0b\x32(.dgraph_tpu_torch.TabletSizes.SizesEntry\x1a,\n\nSizesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\"4\n\x11MoveTabletRequest\x12\x0c\n\x04pred\x18\x01 \x01(\t\x12\x11\n\tdst_group\x18\x02 \x01(\x04\"3\n\x11PullTabletRequest\x12\x0c\n\x04\x61ttr\x18\x01 \x01(\t\x12\x10\n\x08src_addr\x18\x02 \x01(\t\"\x97\x01\n\x0bMutationMsg\x12\x10\n\x08mut_json\x18\x01 \x01(\x0c\x12\x11\n\tcommit_ts\x18\x02 \x01(\x04\x12\x0e\n\x06schema\x18\x03 \x01(\t\x12\x10\n\x08\x64rop_all\x18\x04 \x01(\x08\x12\x0e\n\x06origin\x18\x05 \x01(\x04\x12\x0f\n\x07prev_ts\x18\x06 \x01(\x04\x12\x11\n\tdrop_attr\x18\x07 \x01(\t\x12\r\n\x05stage\x18\x08 \x01(\x08\"@\n\x0b\x44\x65\x63isionMsg\x12\x11\n\tcommit_ts\x18\x01 \x01(\x04\x12\x0e\n\x06\x63ommit\x18\x02 \x01(\x08\x12\x0e\n\x06origin\x18\x03 \x01(\x04\"#\n\x0f\x46\x65tchLogRequest\x12\x10\n\x08since_ts\x18\x01 \x01(\x04\"i\n\tLogRecord\x12\n\n\x02ts\x18\x01 \x01(\x04\x12\x10\n\x08mut_json\x18\x02 \x01(\x0c\x12\x0e\n\x06schema\x18\x03 \x01(\t\x12\x0c\n\x04\x64rop\x18\x04 \x01(\x08\x12\x11\n\tdrop_attr\x18\x05 \x01(\t\x12\r\n\x05\x61\x62ort\x18\x06 \x01(\x08\"L\n\nLogRecords\x12,\n\x07records\x18\x01 \x03(\x0b\x32\x1b.dgraph_tpu_torch.LogRecord\x12\x10\n\x08\x63omplete\x18\x02 \x01(\x08\"6\n\x15TabletSnapshotRequest\x12\x0c\n\x04\x61ttr\x18\x01 \x01(\t\x12\x0f\n\x07read_ts\x18\x02 \x01(\x04\"/\n\x0eTabletSnapshot\x12\x0c\n\x04\x62lob\x18\x01 \x01(\x0c\x12\x0f\n\x07version\x18\x02 \x01(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'dgraph_tpu_torch.protos.task_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REQUEST_VARSENTRY._options = None
  _REQUEST_VARSENTRY._serialized_options = b'8\001'
  _MUTATIONRESP_UIDSENTRY._options = None
  _MUTATIONRESP_UIDSENTRY._serialized_options = b'8\001'
  _GROUP_NODESENTRY._options = None
  _GROUP_NODESENTRY._serialized_options = b'8\001'
  _MEMBERSHIPSTATE_GROUPSENTRY._options = None
  _MEMBERSHIPSTATE_GROUPSENTRY._serialized_options = b'8\001'
  _TABLETSIZES_SIZESENTRY._options = None
  _TABLETSIZES_SIZESENTRY._serialized_options = b'8\001'
  _UIDLIST._serialized_start=56
  _UIDLIST._serialized_end=79
  _TASKQUERY._serialized_start=82
  _TASKQUERY._serialized_end=269
  _UIDMATRIX._serialized_start=271
  _UIDMATRIX._serialized_end=323
  _TASKRESULT._serialized_start=325
  _TASKRESULT._serialized_end=448
  _TXNCONTEXT._serialized_start=450
  _TXNCONTEXT._serialized_end=516
  _REQUEST._serialized_start=519
  _REQUEST._serialized_end=657
  _REQUEST_VARSENTRY._serialized_start=614
  _REQUEST_VARSENTRY._serialized_end=657
  _RESPONSE._serialized_start=659
  _RESPONSE._serialized_end=746
  _MUTATIONREQ._serialized_start=748
  _MUTATIONREQ._serialized_end=875
  _MUTATIONRESP._serialized_start=878
  _MUTATIONRESP._serialized_end=1036
  _MUTATIONRESP_UIDSENTRY._serialized_start=993
  _MUTATIONRESP_UIDSENTRY._serialized_end=1036
  _OPERATION._serialized_start=1038
  _OPERATION._serialized_end=1102
  _ASSIGNREQUEST._serialized_start=1104
  _ASSIGNREQUEST._serialized_end=1132
  _ASSIGNEDIDS._serialized_start=1134
  _ASSIGNEDIDS._serialized_end=1181
  _PAYLOAD._serialized_start=1183
  _PAYLOAD._serialized_end=1206
  _CONNECTREQUEST._serialized_start=1208
  _CONNECTREQUEST._serialized_end=1286
  _CONNECTRESPONSE._serialized_start=1288
  _CONNECTRESPONSE._serialized_end=1340
  _GROUP._serialized_start=1342
  _GROUP._serialized_end=1463
  _GROUP_NODESENTRY._serialized_start=1419
  _GROUP_NODESENTRY._serialized_end=1463
  _MEMBERSHIPSTATE._serialized_start=1466
  _MEMBERSHIPSTATE._serialized_end=1649
  _MEMBERSHIPSTATE_GROUPSENTRY._serialized_start=1579
  _MEMBERSHIPSTATE_GROUPSENTRY._serialized_end=1649
  _HEARTBEATMSG._serialized_start=1651
  _HEARTBEATMSG._serialized_end=1730
  _JOURNALTAILREQUEST._serialized_start=1732
  _JOURNALTAILREQUEST._serialized_end=1781
  _JOURNALDOCS._serialized_start=1783
  _JOURNALDOCS._serialized_end=1862
  _TABLETREQUEST._serialized_start=1864
  _TABLETREQUEST._serialized_end=1908
  _TABLET._serialized_start=1910
  _TABLET._serialized_end=1947
  _TSREQUEST._serialized_start=1949
  _TSREQUEST._serialized_end=1992
  _COMMITREQUEST._serialized_start=1994
  _COMMITREQUEST._serialized_end=2056
  _EMPTY._serialized_start=2058
  _EMPTY._serialized_end=2065
  _TABLETSIZES._serialized_start=2068
  _TABLETSIZES._serialized_end=2199
  _TABLETSIZES_SIZESENTRY._serialized_start=2155
  _TABLETSIZES_SIZESENTRY._serialized_end=2199
  _MOVETABLETREQUEST._serialized_start=2201
  _MOVETABLETREQUEST._serialized_end=2253
  _PULLTABLETREQUEST._serialized_start=2255
  _PULLTABLETREQUEST._serialized_end=2306
  _MUTATIONMSG._serialized_start=2309
  _MUTATIONMSG._serialized_end=2460
  _DECISIONMSG._serialized_start=2462
  _DECISIONMSG._serialized_end=2526
  _FETCHLOGREQUEST._serialized_start=2528
  _FETCHLOGREQUEST._serialized_end=2563
  _LOGRECORD._serialized_start=2565
  _LOGRECORD._serialized_end=2670
  _LOGRECORDS._serialized_start=2672
  _LOGRECORDS._serialized_end=2748
  _TABLETSNAPSHOTREQUEST._serialized_start=2750
  _TABLETSNAPSHOTREQUEST._serialized_end=2804
  _TABLETSNAPSHOT._serialized_start=2806
  _TABLETSNAPSHOT._serialized_end=2853
# @@protoc_insertion_point(module_scope)
