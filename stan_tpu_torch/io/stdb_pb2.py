# -*- coding: utf-8 -*-
# Copied unchanged from stan_tpu/io/stdb_pb2.py; the port keeps its own copy.
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: stdb.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\nstdb.proto\x12\tstan.stdb\"5\n\x08MatrixST\x12\r\n\x01m\x18\x01 \x03(\x01\x42\x02\x10\x00\x12\x0c\n\x04rows\x18\x02 \x01(\x05\x12\x0c\n\x04\x63ols\x18\x03 \x01(\x05\"\x93\x01\n\x04Node\x12\n\n\x02id\x18\x01 \x01(\x05\x12\t\n\x01x\x18\x02 \x01(\x01\x12\t\n\x01y\x18\x03 \x01(\x01\x12\t\n\x01z\x18\x04 \x01(\x01\x12\x11\n\x05\x65list\x18\x05 \x03(\x05\x42\x02\x10\x00\x12\x0f\n\x03\x64of\x18\x06 \x03(\x05\x42\x02\x10\x00\x12\x12\n\x06\x64isp_x\x18\x07 \x03(\x01\x42\x02\x10\x00\x12\x12\n\x06\x64isp_y\x18\x08 \x03(\x01\x42\x02\x10\x00\x12\x12\n\x06\x64isp_z\x18\t \x03(\x01\x42\x02\x10\x00\"\x9d\x01\n\x07\x45lement\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0b\n\x03pid\x18\x03 \x01(\x05\x12\x0e\n\x06mat_id\x18\x04 \x01(\x05\x12\x11\n\x05nlist\x18\x05 \x03(\x05\x42\x02\x10\x00\x12#\n\x06strain\x18\x06 \x03(\x0b\x32\x13.stan.stdb.MatrixST\x12#\n\x06stress\x18\x07 \x03(\x0b\x32\x13.stan.stdb.MatrixST\"`\n\x08Material\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x0c\n\x04type\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\t\n\x01\x65\x18\x04 \x01(\x01\x12\x0f\n\x07poisson\x18\x05 \x01(\x01\x12\x10\n\x08\x63olor_id\x18\x06 \x01(\x05\"\xdb\x01\n\x11\x42oundaryCondition\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 \x01(\x05\x12\x43\n\x0cnodal_values\x18\x04 \x03(\x0b\x32-.stan.stdb.BoundaryCondition.NodalValuesEntry\x12\x10\n\x08\x63olor_id\x18\x05 \x01(\x05\x1aG\n\x10NodalValuesEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.stan.stdb.MatrixST:\x02\x38\x01\"\x91\x01\n\x08\x41nalysis\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x12\n\nlin_solver\x18\x02 \x01(\t\x12\x1c\n\x14lin_solver_tolerance\x18\x03 \x01(\x01\x12\x1b\n\x13lin_solver_iter_max\x18\x04 \x01(\x05\x12\x10\n\x08inc_numb\x18\x05 \x01(\x05\x12\x16\n\x0eresult_step_no\x18\x06 \x01(\x05\"r\n\x08PartInfo\x12\x10\n\x08\x63olor_id\x18\x01 \x01(\x05\x12\x0e\n\x06mat_id\x18\x02 \x01(\x05\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x10\n\x08hex_type\x18\x04 \x01(\t\x12\x12\n\npenta_type\x18\x05 \x01(\t\x12\x10\n\x08tet_type\x18\x06 \x01(\t\"\x8c\x01\n\x0bInformation\x12\x37\n\tinfo_part\x18\x01 \x03(\x0b\x32$.stan.stdb.Information.InfoPartEntry\x1a\x44\n\rInfoPartEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.stan.stdb.PartInfo:\x02\x38\x01\"\xc9\x04\n\x08\x44\x61tabase\x12\x32\n\x08node_lib\x18\x01 \x03(\x0b\x32 .stan.stdb.Database.NodeLibEntry\x12\x32\n\x08\x65lem_lib\x18\x02 \x03(\x0b\x32 .stan.stdb.Database.ElemLibEntry\x12\x30\n\x07mat_lib\x18\x03 \x03(\x0b\x32\x1f.stan.stdb.Database.MatLibEntry\x12.\n\x06\x62\x63_lib\x18\x04 \x03(\x0b\x32\x1e.stan.stdb.Database.BcLibEntry\x12\r\n\x05n_dof\x18\x05 \x01(\x05\x12)\n\x0c\x61nalysis_lib\x18\x06 \x01(\x0b\x32\x13.stan.stdb.Analysis\x12$\n\x04info\x18\x07 \x01(\x0b\x32\x16.stan.stdb.Information\x1a?\n\x0cNodeLibEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\x1e\n\x05value\x18\x02 \x01(\x0b\x32\x0f.stan.stdb.Node:\x02\x38\x01\x1a\x42\n\x0c\x45lemLibEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12!\n\x05value\x18\x02 \x01(\x0b\x32\x12.stan.stdb.Element:\x02\x38\x01\x1a\x42\n\x0bMatLibEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12\"\n\x05value\x18\x02 \x01(\x0b\x32\x13.stan.stdb.Material:\x02\x38\x01\x1aJ\n\nBcLibEntry\x12\x0b\n\x03key\x18\x01 \x01(\x05\x12+\n\x05value\x18\x02 \x01(\x0b\x32\x1c.stan.stdb.BoundaryCondition:\x02\x38\x01')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'stdb_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MATRIXST.fields_by_name['m']._options = None
  _MATRIXST.fields_by_name['m']._serialized_options = b'\020\000'
  _NODE.fields_by_name['elist']._options = None
  _NODE.fields_by_name['elist']._serialized_options = b'\020\000'
  _NODE.fields_by_name['dof']._options = None
  _NODE.fields_by_name['dof']._serialized_options = b'\020\000'
  _NODE.fields_by_name['disp_x']._options = None
  _NODE.fields_by_name['disp_x']._serialized_options = b'\020\000'
  _NODE.fields_by_name['disp_y']._options = None
  _NODE.fields_by_name['disp_y']._serialized_options = b'\020\000'
  _NODE.fields_by_name['disp_z']._options = None
  _NODE.fields_by_name['disp_z']._serialized_options = b'\020\000'
  _ELEMENT.fields_by_name['nlist']._options = None
  _ELEMENT.fields_by_name['nlist']._serialized_options = b'\020\000'
  _BOUNDARYCONDITION_NODALVALUESENTRY._options = None
  _BOUNDARYCONDITION_NODALVALUESENTRY._serialized_options = b'8\001'
  _INFORMATION_INFOPARTENTRY._options = None
  _INFORMATION_INFOPARTENTRY._serialized_options = b'8\001'
  _DATABASE_NODELIBENTRY._options = None
  _DATABASE_NODELIBENTRY._serialized_options = b'8\001'
  _DATABASE_ELEMLIBENTRY._options = None
  _DATABASE_ELEMLIBENTRY._serialized_options = b'8\001'
  _DATABASE_MATLIBENTRY._options = None
  _DATABASE_MATLIBENTRY._serialized_options = b'8\001'
  _DATABASE_BCLIBENTRY._options = None
  _DATABASE_BCLIBENTRY._serialized_options = b'8\001'
  _MATRIXST._serialized_start=25
  _MATRIXST._serialized_end=78
  _NODE._serialized_start=81
  _NODE._serialized_end=228
  _ELEMENT._serialized_start=231
  _ELEMENT._serialized_end=388
  _MATERIAL._serialized_start=390
  _MATERIAL._serialized_end=486
  _BOUNDARYCONDITION._serialized_start=489
  _BOUNDARYCONDITION._serialized_end=708
  _BOUNDARYCONDITION_NODALVALUESENTRY._serialized_start=637
  _BOUNDARYCONDITION_NODALVALUESENTRY._serialized_end=708
  _ANALYSIS._serialized_start=711
  _ANALYSIS._serialized_end=856
  _PARTINFO._serialized_start=858
  _PARTINFO._serialized_end=972
  _INFORMATION._serialized_start=975
  _INFORMATION._serialized_end=1115
  _INFORMATION_INFOPARTENTRY._serialized_start=1047
  _INFORMATION_INFOPARTENTRY._serialized_end=1115
  _DATABASE._serialized_start=1118
  _DATABASE._serialized_end=1703
  _DATABASE_NODELIBENTRY._serialized_start=1428
  _DATABASE_NODELIBENTRY._serialized_end=1491
  _DATABASE_ELEMLIBENTRY._serialized_start=1493
  _DATABASE_ELEMLIBENTRY._serialized_end=1559
  _DATABASE_MATLIBENTRY._serialized_start=1561
  _DATABASE_MATLIBENTRY._serialized_end=1627
  _DATABASE_BCLIBENTRY._serialized_start=1629
  _DATABASE_BCLIBENTRY._serialized_end=1703
# @@protoc_insertion_point(module_scope)
