# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: etcd.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\netcd.proto\x12\x0c\x65tcdserverpb\"\\\n\x0eResponseHeader\x12\x12\n\ncluster_id\x18\x01 \x01(\x04\x12\x11\n\tmember_id\x18\x02 \x01(\x04\x12\x10\n\x08revision\x18\x03 \x01(\x03\x12\x11\n\traft_term\x18\x04 \x01(\x04\"u\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x17\n\x0f\x63reate_revision\x18\x02 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x03 \x01(\x03\x12\x0f\n\x07version\x18\x04 \x01(\x03\x12\r\n\x05value\x18\x05 \x01(\x0c\x12\r\n\x05lease\x18\x06 \x01(\x03\"\xa3\x01\n\x05\x45vent\x12+\n\x04type\x18\x01 \x01(\x0e\x32\x1d.etcdserverpb.Event.EventType\x12\"\n\x02kv\x18\x02 \x01(\x0b\x32\x16.etcdserverpb.KeyValue\x12\'\n\x07prev_kv\x18\x03 \x01(\x0b\x32\x16.etcdserverpb.KeyValue\" \n\tEventType\x12\x07\n\x03PUT\x10\x00\x12\n\n\x06\x44\x45LETE\x10\x01\"\xb5\x01\n\x0cRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x10\n\x08revision\x18\x04 \x01(\x03\x12\x12\n\nsort_order\x18\x05 \x01(\x05\x12\x13\n\x0bsort_target\x18\x06 \x01(\x05\x12\x14\n\x0cserializable\x18\x07 \x01(\x08\x12\x11\n\tkeys_only\x18\x08 \x01(\x08\x12\x12\n\ncount_only\x18\t \x01(\x08\"\x7f\n\rRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12#\n\x03kvs\x18\x02 \x03(\x0b\x32\x16.etcdserverpb.KeyValue\x12\x0c\n\x04more\x18\x03 \x01(\x08\x12\r\n\x05\x63ount\x18\x04 \x01(\x03\"H\n\nPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05lease\x18\x03 \x01(\x03\x12\x0f\n\x07prev_kv\x18\x04 \x01(\x08\"d\n\x0bPutResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\'\n\x07prev_kv\x18\x02 \x01(\x0b\x32\x16.etcdserverpb.KeyValue\"E\n\x12\x44\x65leteRangeRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x0f\n\x07prev_kv\x18\x03 \x01(\x08\"~\n\x13\x44\x65leteRangeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x0f\n\x07\x64\x65leted\x18\x02 \x01(\x03\x12(\n\x08prev_kvs\x18\x03 \x03(\x0b\x32\x16.etcdserverpb.KeyValue\"\x87\x01\n\x12WatchCreateRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12\x11\n\trange_end\x18\x02 \x01(\x0c\x12\x16\n\x0estart_revision\x18\x03 \x01(\x03\x12\x17\n\x0fprogress_notify\x18\x04 \x01(\x08\x12\x0f\n\x07\x66ilters\x18\x05 \x03(\x05\x12\x0f\n\x07prev_kv\x18\x06 \x01(\x08\"&\n\x12WatchCancelRequest\x12\x10\n\x08watch_id\x18\x01 \x01(\x03\"\x97\x01\n\x0cWatchRequest\x12:\n\x0e\x63reate_request\x18\x01 \x01(\x0b\x32 .etcdserverpb.WatchCreateRequestH\x00\x12:\n\x0e\x63\x61ncel_request\x18\x02 \x01(\x0b\x32 .etcdserverpb.WatchCancelRequestH\x00\x42\x0f\n\rrequest_union\"\xc8\x01\n\rWatchResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x10\n\x08watch_id\x18\x02 \x01(\x03\x12\x0f\n\x07\x63reated\x18\x03 \x01(\x08\x12\x10\n\x08\x63\x61nceled\x18\x04 \x01(\x08\x12\x18\n\x10\x63ompact_revision\x18\x05 \x01(\x03\x12\x15\n\rcancel_reason\x18\x06 \x01(\t\x12#\n\x06\x65vents\x18\x0b \x03(\x0b\x32\x13.etcdserverpb.Event\",\n\x11LeaseGrantRequest\x12\x0b\n\x03TTL\x18\x01 \x01(\x03\x12\n\n\x02ID\x18\x02 \x01(\x03\"j\n\x12LeaseGrantResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\x12\r\n\x05\x65rror\x18\x04 \x01(\t\"#\n\x15LeaseKeepAliveRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"_\n\x16LeaseKeepAliveResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\n\n\x02ID\x18\x02 \x01(\x03\x12\x0b\n\x03TTL\x18\x03 \x01(\x03\" \n\x12LeaseRevokeRequest\x12\n\n\x02ID\x18\x01 \x01(\x03\"C\n\x13LeaseRevokeResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\"*\n\x0bLockRequest\x12\x0c\n\x04name\x18\x01 \x01(\x0c\x12\r\n\x05lease\x18\x02 \x01(\x03\"I\n\x0cLockResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader\x12\x0b\n\x03key\x18\x02 \x01(\x0c\"\x1c\n\rUnlockRequest\x12\x0b\n\x03key\x18\x01 \x01(\x0c\">\n\x0eUnlockResponse\x12,\n\x06header\x18\x01 \x01(\x0b\x32\x1c.etcdserverpb.ResponseHeader2\xdc\x01\n\x02KV\x12\x42\n\x05Range\x12\x1a.etcdserverpb.RangeRequest\x1a\x1b.etcdserverpb.RangeResponse\"\x00\x12<\n\x03Put\x12\x18.etcdserverpb.PutRequest\x1a\x19.etcdserverpb.PutResponse\"\x00\x12T\n\x0b\x44\x65leteRange\x12 .etcdserverpb.DeleteRangeRequest\x1a!.etcdserverpb.DeleteRangeResponse\"\x00\x32O\n\x05Watch\x12\x46\n\x05Watch\x12\x1a.etcdserverpb.WatchRequest\x1a\x1b.etcdserverpb.WatchResponse\"\x00(\x01\x30\x01\x32\x93\x02\n\x05Lease\x12Q\n\nLeaseGrant\x12\x1f.etcdserverpb.LeaseGrantRequest\x1a .etcdserverpb.LeaseGrantResponse\"\x00\x12T\n\x0bLeaseRevoke\x12 .etcdserverpb.LeaseRevokeRequest\x1a!.etcdserverpb.LeaseRevokeResponse\"\x00\x12\x61\n\x0eLeaseKeepAlive\x12#.etcdserverpb.LeaseKeepAliveRequest\x1a$.etcdserverpb.LeaseKeepAliveResponse\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'etcd_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESPONSEHEADER._serialized_start=28
  _RESPONSEHEADER._serialized_end=120
  _KEYVALUE._serialized_start=122
  _KEYVALUE._serialized_end=239
  _EVENT._serialized_start=242
  _EVENT._serialized_end=405
  _EVENT_EVENTTYPE._serialized_start=373
  _EVENT_EVENTTYPE._serialized_end=405
  _RANGEREQUEST._serialized_start=408
  _RANGEREQUEST._serialized_end=589
  _RANGERESPONSE._serialized_start=591
  _RANGERESPONSE._serialized_end=718
  _PUTREQUEST._serialized_start=720
  _PUTREQUEST._serialized_end=792
  _PUTRESPONSE._serialized_start=794
  _PUTRESPONSE._serialized_end=894
  _DELETERANGEREQUEST._serialized_start=896
  _DELETERANGEREQUEST._serialized_end=965
  _DELETERANGERESPONSE._serialized_start=967
  _DELETERANGERESPONSE._serialized_end=1093
  _WATCHCREATEREQUEST._serialized_start=1096
  _WATCHCREATEREQUEST._serialized_end=1231
  _WATCHCANCELREQUEST._serialized_start=1233
  _WATCHCANCELREQUEST._serialized_end=1271
  _WATCHREQUEST._serialized_start=1274
  _WATCHREQUEST._serialized_end=1425
  _WATCHRESPONSE._serialized_start=1428
  _WATCHRESPONSE._serialized_end=1628
  _LEASEGRANTREQUEST._serialized_start=1630
  _LEASEGRANTREQUEST._serialized_end=1674
  _LEASEGRANTRESPONSE._serialized_start=1676
  _LEASEGRANTRESPONSE._serialized_end=1782
  _LEASEKEEPALIVEREQUEST._serialized_start=1784
  _LEASEKEEPALIVEREQUEST._serialized_end=1819
  _LEASEKEEPALIVERESPONSE._serialized_start=1821
  _LEASEKEEPALIVERESPONSE._serialized_end=1916
  _LEASEREVOKEREQUEST._serialized_start=1918
  _LEASEREVOKEREQUEST._serialized_end=1950
  _LEASEREVOKERESPONSE._serialized_start=1952
  _LEASEREVOKERESPONSE._serialized_end=2019
  _LOCKREQUEST._serialized_start=2021
  _LOCKREQUEST._serialized_end=2063
  _LOCKRESPONSE._serialized_start=2065
  _LOCKRESPONSE._serialized_end=2138
  _UNLOCKREQUEST._serialized_start=2140
  _UNLOCKREQUEST._serialized_end=2168
  _UNLOCKRESPONSE._serialized_start=2170
  _UNLOCKRESPONSE._serialized_end=2232
  _KV._serialized_start=2235
  _KV._serialized_end=2455
  _WATCH._serialized_start=2457
  _WATCH._serialized_end=2536
  _LEASE._serialized_start=2539
  _LEASE._serialized_end=2814
# @@protoc_insertion_point(module_scope)
