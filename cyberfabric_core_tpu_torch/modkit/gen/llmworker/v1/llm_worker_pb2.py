# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: llmworker/v1/llm_worker.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1dllmworker/v1/llm_worker.proto\x12\x0cllmworker.v1\x1a\x1cgoogle/protobuf/struct.proto\"\x9b\x02\n\x08ModelRef\x12\x14\n\x0c\x63\x61nonical_id\x18\x01 \x01(\t\x12\x15\n\rprovider_slug\x18\x02 \x01(\t\x12\x19\n\x11provider_model_id\x18\x03 \x01(\t\x12\x0f\n\x07managed\x18\x04 \x01(\x08\x12\x14\n\x0c\x61rchitecture\x18\x05 \x01(\t\x12\x17\n\x0f\x63heckpoint_path\x18\x06 \x01(\t\x12/\n\x0e\x65ngine_options\x18\x07 \x01(\x0b\x32\x17.google.protobuf.Struct\x12\'\n\x06limits\x18\x08 \x01(\x0b\x32\x17.google.protobuf.Struct\x12-\n\x0c\x63\x61pabilities\x18\t \x01(\x0b\x32\x17.google.protobuf.Struct\"|\n\x07Message\x12\x0c\n\x04role\x18\x01 \x01(\t\x12(\n\x07\x63ontent\x18\x02 \x03(\x0b\x32\x17.google.protobuf.Struct\x12+\n\ntool_calls\x18\x03 \x03(\x0b\x32\x17.google.protobuf.Struct\x12\x0c\n\x04name\x18\x04 \x01(\t\"\x86\x01\n\x0b\x43hatRequest\x12%\n\x05model\x18\x01 \x01(\x0b\x32\x16.llmworker.v1.ModelRef\x12\'\n\x08messages\x18\x02 \x03(\x0b\x32\x15.llmworker.v1.Message\x12\'\n\x06params\x18\x03 \x01(\x0b\x32\x17.google.protobuf.Struct\"s\n\x11\x43ompletionRequest\x12%\n\x05model\x18\x01 \x01(\x0b\x32\x16.llmworker.v1.ModelRef\x12\x0e\n\x06prompt\x18\x02 \x01(\t\x12\'\n\x06params\x18\x03 \x01(\x0b\x32\x17.google.protobuf.Struct\"4\n\x05Usage\x12\x14\n\x0cinput_tokens\x18\x01 \x01(\x05\x12\x15\n\routput_tokens\x18\x02 \x01(\x05\"\x92\x01\n\x0bStreamChunk\x12\x12\n\nrequest_id\x18\x01 \x01(\t\x12\x0c\n\x04text\x18\x02 \x01(\t\x12\x10\n\x08token_id\x18\x03 \x01(\x05\x12\x14\n\x0chas_token_id\x18\x04 \x01(\x08\x12\x15\n\rfinish_reason\x18\x05 \x01(\t\x12\"\n\x05usage\x18\x06 \x01(\x0b\x32\x13.llmworker.v1.Usage\"n\n\x0c\x45mbedRequest\x12%\n\x05model\x18\x01 \x01(\x0b\x32\x16.llmworker.v1.ModelRef\x12\x0e\n\x06inputs\x18\x02 \x03(\t\x12\'\n\x06params\x18\x03 \x01(\x0b\x32\x17.google.protobuf.Struct\"\x1b\n\tEmbedding\x12\x0e\n\x06values\x18\x01 \x03(\x02\"R\n\rEmbedResponse\x12+\n\nembeddings\x18\x01 \x03(\x0b\x32\x17.llmworker.v1.Embedding\x12\x14\n\x0ctotal_tokens\x18\x02 \x01(\x05\"\x0f\n\rHealthRequest\"I\n\x0eHealthResponse\x12\x0e\n\x06status\x18\x01 \x01(\t\x12\'\n\x06\x64\x65tail\x18\x02 \x01(\x0b\x32\x17.google.protobuf.Struct2\xab\x02\n\x10LlmWorkerService\x12\x44\n\nChatStream\x12\x19.llmworker.v1.ChatRequest\x1a\x19.llmworker.v1.StreamChunk0\x01\x12J\n\nCompletion\x12\x1f.llmworker.v1.CompletionRequest\x1a\x19.llmworker.v1.StreamChunk0\x01\x12@\n\x05\x45mbed\x12\x1a.llmworker.v1.EmbedRequest\x1a\x1b.llmworker.v1.EmbedResponse\x12\x43\n\x06Health\x12\x1b.llmworker.v1.HealthRequest\x1a\x1c.llmworker.v1.HealthResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'llmworker.v1.llm_worker_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELREF._serialized_start=78
  _MODELREF._serialized_end=361
  _MESSAGE._serialized_start=363
  _MESSAGE._serialized_end=487
  _CHATREQUEST._serialized_start=490
  _CHATREQUEST._serialized_end=624
  _COMPLETIONREQUEST._serialized_start=626
  _COMPLETIONREQUEST._serialized_end=741
  _USAGE._serialized_start=743
  _USAGE._serialized_end=795
  _STREAMCHUNK._serialized_start=798
  _STREAMCHUNK._serialized_end=944
  _EMBEDREQUEST._serialized_start=946
  _EMBEDREQUEST._serialized_end=1056
  _EMBEDDING._serialized_start=1058
  _EMBEDDING._serialized_end=1085
  _EMBEDRESPONSE._serialized_start=1087
  _EMBEDRESPONSE._serialized_end=1169
  _HEALTHREQUEST._serialized_start=1171
  _HEALTHREQUEST._serialized_end=1186
  _HEALTHRESPONSE._serialized_start=1188
  _HEALTHRESPONSE._serialized_end=1261
  _LLMWORKERSERVICE._serialized_start=1264
  _LLMWORKERSERVICE._serialized_end=1563
# @@protoc_insertion_point(module_scope)
