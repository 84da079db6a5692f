# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: directory/v1/directory.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1c\x64irectory/v1/directory.proto\x12\x0c\x64irectory.v1\"k\n\x17RegisterInstanceRequest\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\x12\x14\n\x0cservice_name\x18\x02 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x03 \x01(\t\x12\x13\n\x0bmodule_name\x18\x04 \x01(\t\"/\n\x18RegisterInstanceResponse\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\"\"\n\x0bInstanceRef\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\"\x11\n\x03\x41\x63k\x12\n\n\x02ok\x18\x01 \x01(\x08\"&\n\x0eResolveRequest\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\"`\n\x0cInstanceInfo\x12\x13\n\x0binstance_id\x18\x01 \x01(\t\x12\x14\n\x0cservice_name\x18\x02 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x03 \x01(\t\x12\x13\n\x0bmodule_name\x18\x04 \x01(\t\"\r\n\x0bListRequest\"=\n\x0cListResponse\x12-\n\tinstances\x18\x01 \x03(\x0b\x32\x1a.directory.v1.InstanceInfo2\x8c\x03\n\x10\x44irectoryService\x12\x61\n\x10RegisterInstance\x12%.directory.v1.RegisterInstanceRequest\x1a&.directory.v1.RegisterInstanceResponse\x12\x42\n\x12\x44\x65registerInstance\x12\x19.directory.v1.InstanceRef\x1a\x11.directory.v1.Ack\x12\x39\n\tHeartbeat\x12\x19.directory.v1.InstanceRef\x1a\x11.directory.v1.Ack\x12N\n\x12ResolveGrpcService\x12\x1c.directory.v1.ResolveRequest\x1a\x1a.directory.v1.InstanceInfo\x12\x46\n\rListInstances\x12\x19.directory.v1.ListRequest\x1a\x1a.directory.v1.ListResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'directory.v1.directory_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REGISTERINSTANCEREQUEST._serialized_start=46
  _REGISTERINSTANCEREQUEST._serialized_end=153
  _REGISTERINSTANCERESPONSE._serialized_start=155
  _REGISTERINSTANCERESPONSE._serialized_end=202
  _INSTANCEREF._serialized_start=204
  _INSTANCEREF._serialized_end=238
  _ACK._serialized_start=240
  _ACK._serialized_end=257
  _RESOLVEREQUEST._serialized_start=259
  _RESOLVEREQUEST._serialized_end=297
  _INSTANCEINFO._serialized_start=299
  _INSTANCEINFO._serialized_end=395
  _LISTREQUEST._serialized_start=397
  _LISTREQUEST._serialized_end=410
  _LISTRESPONSE._serialized_start=412
  _LISTRESPONSE._serialized_end=473
  _DIRECTORYSERVICE._serialized_start=476
  _DIRECTORYSERVICE._serialized_end=872
# @@protoc_insertion_point(module_scope)
