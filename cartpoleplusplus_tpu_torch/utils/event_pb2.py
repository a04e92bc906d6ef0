# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: event.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0b\x65vent.proto\x12\x14\x63\x61rtpoleplusplus_tpu\"`\n\x04Pose\x12\x10\n\x08position\x18\x01 \x03(\x02\x12\x13\n\x0borientation\x18\x02 \x03(\x02\x12\x17\n\x0flinear_velocity\x18\x03 \x03(\x02\x12\x18\n\x10\x61ngular_velocity\x18\x04 \x03(\x02\"\x99\x01\n\x05\x45vent\x12(\n\x04\x63\x61rt\x18\x01 \x01(\x0b\x32\x1a.cartpoleplusplus_tpu.Pose\x12(\n\x04pole\x18\x02 \x01(\x0b\x32\x1a.cartpoleplusplus_tpu.Pose\x12\x0e\n\x06render\x18\x03 \x03(\x0c\x12\x0e\n\x06\x61\x63tion\x18\x04 \x03(\x02\x12\x0e\n\x06reward\x18\x05 \x01(\x02\x12\x0c\n\x04\x64one\x18\x06 \x01(\x08\"5\n\x07\x45pisode\x12*\n\x05\x65vent\x18\x01 \x03(\x0b\x32\x1b.cartpoleplusplus_tpu.Eventb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'event_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _POSE._serialized_start=37
  _POSE._serialized_end=133
  _EVENT._serialized_start=136
  _EVENT._serialized_end=289
  _EPISODE._serialized_start=291
  _EPISODE._serialized_end=344
# @@protoc_insertion_point(module_scope)
