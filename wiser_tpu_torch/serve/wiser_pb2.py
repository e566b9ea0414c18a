# The wire messages of wiser.proto, the same as wiser_tpu/serve/wiser_pb2.py
# (one descriptor, so the two packages' clients and servers interoperate).
# It imports google.protobuf: only the gRPC entry points import it.
# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: wiser.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bwiser.proto\x12\x05wiser\"y\n\rSearchRequest\x12\r\n\x05terms\x18\x01 \x03(\t\x12\x11\n\tn_results\x18\x02 \x01(\x05\x12\x17\n\x0freturn_snippets\x18\x03 \x01(\x08\x12\x1a\n\x12n_snippet_passages\x18\x04 \x01(\x05\x12\x11\n\tis_phrase\x18\x05 \x01(\x08\"F\n\x10SearchReplyEntry\x12\x0e\n\x06\x64oc_id\x18\x01 \x01(\x03\x12\x0f\n\x07snippet\x18\x02 \x01(\t\x12\x11\n\tdoc_score\x18\x03 \x01(\x01\"7\n\x0bSearchReply\x12(\n\x07\x65ntries\x18\x01 \x03(\x0b\x32\x17.wiser.SearchReplyEntry\"<\n\x12SearchRequestBatch\x12&\n\x08requests\x18\x01 \x03(\x0b\x32\x14.wiser.SearchRequest\"7\n\x10SearchReplyBatch\x12#\n\x07replies\x18\x01 \x03(\x0b\x32\x12.wiser.SearchReply\"V\n\x12\x41\x64\x64\x44ocumentRequest\x12\x0c\n\x04\x62ody\x18\x01 \x01(\t\x12\x0e\n\x06tokens\x18\x02 \x01(\t\x12\x0f\n\x07offsets\x18\x03 \x01(\t\x12\x11\n\tpositions\x18\x04 \x01(\t\"*\n\x0bStatusReply\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"\x1b\n\x08\x45\x63hoData\x12\x0f\n\x07message\x18\x01 \x01(\t2\xb6\x02\n\x0bWiserEngine\x12?\n\x0fStreamingSearch\x12\x14.wiser.SearchRequest\x1a\x12.wiser.SearchReply(\x01\x30\x01\x12\x45\n\x0b\x42\x61tchSearch\x12\x19.wiser.SearchRequestBatch\x1a\x17.wiser.SearchReplyBatch(\x01\x30\x01\x12\x37\n\x0bUnarySearch\x12\x14.wiser.SearchRequest\x1a\x12.wiser.SearchReply\x12<\n\x0b\x41\x64\x64\x44ocument\x12\x19.wiser.AddDocumentRequest\x1a\x12.wiser.StatusReply\x12(\n\x04\x45\x63ho\x12\x0f.wiser.EchoData\x1a\x0f.wiser.EchoDatab\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'wiser_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SEARCHREQUEST._serialized_start=22
  _SEARCHREQUEST._serialized_end=143
  _SEARCHREPLYENTRY._serialized_start=145
  _SEARCHREPLYENTRY._serialized_end=215
  _SEARCHREPLY._serialized_start=217
  _SEARCHREPLY._serialized_end=272
  _SEARCHREQUESTBATCH._serialized_start=274
  _SEARCHREQUESTBATCH._serialized_end=334
  _SEARCHREPLYBATCH._serialized_start=336
  _SEARCHREPLYBATCH._serialized_end=391
  _ADDDOCUMENTREQUEST._serialized_start=393
  _ADDDOCUMENTREQUEST._serialized_end=479
  _STATUSREPLY._serialized_start=481
  _STATUSREPLY._serialized_end=523
  _ECHODATA._serialized_start=525
  _ECHODATA._serialized_end=552
  _WISERENGINE._serialized_start=555
  _WISERENGINE._serialized_end=865
# @@protoc_insertion_point(module_scope)
