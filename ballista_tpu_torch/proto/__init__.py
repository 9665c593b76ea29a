"""Generated protobuf bindings: a verbatim copy of the reference's
``ballista_tpu/proto/ballista_tpu_pb2.py`` (protoc --python_out against
``proto/ballista_tpu.proto``), so that the port's plans and the
reference's are the same bytes on the wire. Both copies load into the
default descriptor pool under the same file name and hand out the same
message classes."""

from ballista_tpu_torch.proto import ballista_tpu_pb2 as pb

__all__ = ["pb"]
