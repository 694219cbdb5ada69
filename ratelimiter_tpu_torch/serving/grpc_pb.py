"""The gRPC contract's message classes, built from a committed descriptor.

``api/proto/ratelimiter.proto`` compiled by ``protoc --python_out``
(libprotoc 3.21.12) embeds the file's serialized ``FileDescriptorProto``
in the generated module; ``SERIALIZED_FILE`` is those bytes, committed,
so serving gRPC needs no ``protoc`` and no ``grpc_tools`` at run time
(the JAX server generates its module on first use).
``tests/test_torch_grpc.py`` regenerates them with ``protoc`` where it
is installed and compares the bytes.

The classes are built in a private ``descriptor_pool.DescriptorPool``,
not the process default: a process that also imports a generated
``ratelimiter_pb2`` (the JAX package's) would otherwise register
``ratelimiter.proto`` twice. The two packages' messages are then
different classes with the same wire bytes. ``message_factory.
GetMessageClass`` builds them where the protobuf runtime has it, and
``MessageFactory(pool).GetPrototype`` where it does not (protobuf 3.20
to 6.x).

``load()`` returns a namespace with one attribute per message type
(``AllowRequest``, ``AllowResponse``, ...), as a generated module has,
plus ``SERVICE``, the service's full name.
"""

from __future__ import annotations

import threading
from types import SimpleNamespace

SERVICE = "ratelimiter.v1.RateLimiter"
PROTO_FILE = "ratelimiter.proto"

SERIALIZED_FILE = (
    b'\n\x11ratelimiter.proto\x12\x0eratelimiter.v1"\x1b\n\x0cAllowRequ'
    b'est\x12\x0b\n\x03key\x18\x01 \x01(\t"\'\n\rAllowNRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\t'
    b'\n\x01n\x18\x02 \x01(\r"j\n\x11AllowBatchRequest\x125\n\x05items\x18\x01 \x03(\x0b2&.'
    b'ratelimiter.v1.AllowBatchRequest.Item\x1a\x1e\n\x04Item\x12\x0b\n'
    b'\x03key\x18\x01 \x01(\t\x12\t\n\x01n\x18\x02 \x01(\r"|\n\rAllowResponse\x12\x0f\n\x07allowe'
    b'd\x18\x01 \x01(\x08\x12\r\n\x05limit\x18\x02 \x01(\x03\x12\x11\n\tremaining\x18\x03 \x01(\x03\x12\x13\n\x0bret'
    b'ry_after\x18\x04 \x01(\x01\x12\x10\n\x08reset_at\x18\x05 \x01(\x01\x12\x11\n\tfail_open\x18\x06 '
    b'\x01(\x08"D\n\x12AllowBatchResponse\x12.\n\x07results\x18\x01 \x03(\x0b2\x1d.rat'
    b'elimiter.v1.AllowResponse"\x1b\n\x0cResetRequest\x12\x0b\n\x03key'
    b'\x18\x01 \x01(\t"\x0f\n\rResetResponse"F\n\x12SetOverrideRequest\x12\x0b\n'
    b'\x03key\x18\x01 \x01(\t\x12\r\n\x05limit\x18\x02 \x01(\x03\x12\x14\n\x0cwindow_scale\x18\x03 \x01(\x01"'
    b'!\n\x12GetOverrideRequest\x12\x0b\n\x03key\x18\x01 \x01(\t"$\n\x15DeleteOver'
    b'rideRequest\x12\x0b\n\x03key\x18\x01 \x01(\t"S\n\x10OverrideResponse\x12\r\n\x05'
    b'found\x18\x01 \x01(\x08\x12\x0b\n\x03key\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\x03\x12\x14\n\x0cwindo'
    b'w_scale\x18\x04 \x01(\x01")\n\x16DeleteOverrideResponse\x12\x0f\n\x07delet'
    b'ed\x18\x01 \x01(\x08"N\n\x10SetTenantRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05li'
    b'mit\x18\x02 \x01(\x03\x12\x0e\n\x06weight\x18\x03 \x01(\r\x12\r\n\x05floor\x18\x04 \x01(\x03" \n\x10GetT'
    b'enantRequest\x12\x0c\n\x04name\x18\x01 \x01(\t"h\n\x0eTenantResponse\x12\r\n\x05'
    b'found\x18\x01 \x01(\x08\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0b\n\x03tid\x18\x03 \x01(\x03\x12\r\n\x05limit\x18'
    b'\x04 \x01(\x03\x12\x0e\n\x06weight\x18\x05 \x01(\r\x12\r\n\x05floor\x18\x06 \x01(\x03"#\n\x13DeleteTe'
    b'nantRequest\x12\x0c\n\x04name\x18\x01 \x01(\t"\'\n\x14DeleteTenantRespons'
    b'e\x12\x0f\n\x07deleted\x18\x01 \x01(\x08"2\n\x13AssignTenantRequest\x12\x0b\n\x03key'
    b'\x18\x01 \x01(\t\x12\x0e\n\x06tenant\x18\x02 \x01(\t"\x16\n\x14AssignTenantResponse"$'
    b'\n\x15UnassignTenantRequest\x12\x0b\n\x03key\x18\x01 \x01(\t",\n\x16Unassign'
    b'TenantResponse\x12\x12\n\nunassigned\x18\x01 \x01(\x08"\x0f\n\rHealthRequ'
    b'est"R\n\x0eHealthResponse\x12\x0f\n\x07serving\x18\x01 \x01(\x08\x12\x16\n\x0euptime'
    b'_seconds\x18\x02 \x01(\x01\x12\x17\n\x0fdecisions_total\x18\x03 \x01(\x042\xbf\x08\n\x0bRate'
    b'Limiter\x12D\n\x05Allow\x12\x1c.ratelimiter.v1.AllowRequest\x1a\x1d'
    b'.ratelimiter.v1.AllowResponse\x12F\n\x06AllowN\x12\x1d.rateli'
    b'miter.v1.AllowNRequest\x1a\x1d.ratelimiter.v1.AllowRes'
    b'ponse\x12S\n\nAllowBatch\x12!.ratelimiter.v1.AllowBatchR'
    b'equest\x1a".ratelimiter.v1.AllowBatchResponse\x12D\n\x05Re'
    b'set\x12\x1c.ratelimiter.v1.ResetRequest\x1a\x1d.ratelimiter.'
    b'v1.ResetResponse\x12G\n\x06Health\x12\x1d.ratelimiter.v1.Heal'
    b'thRequest\x1a\x1e.ratelimiter.v1.HealthResponse\x12S\n\x0bSet'
    b'Override\x12".ratelimiter.v1.SetOverrideRequest\x1a .r'
    b'atelimiter.v1.OverrideResponse\x12S\n\x0bGetOverride\x12".'
    b'ratelimiter.v1.GetOverrideRequest\x1a .ratelimiter.'
    b'v1.OverrideResponse\x12_\n\x0eDeleteOverride\x12%.ratelimi'
    b'ter.v1.DeleteOverrideRequest\x1a&.ratelimiter.v1.De'
    b'leteOverrideResponse\x12M\n\tSetTenant\x12 .ratelimiter.'
    b'v1.SetTenantRequest\x1a\x1e.ratelimiter.v1.TenantRespo'
    b'nse\x12M\n\tGetTenant\x12 .ratelimiter.v1.GetTenantReque'
    b'st\x1a\x1e.ratelimiter.v1.TenantResponse\x12Y\n\x0cDeleteTena'
    b'nt\x12#.ratelimiter.v1.DeleteTenantRequest\x1a$.rateli'
    b'miter.v1.DeleteTenantResponse\x12Y\n\x0cAssignTenant\x12#.'
    b'ratelimiter.v1.AssignTenantRequest\x1a$.ratelimiter'
    b'.v1.AssignTenantResponse\x12_\n\x0eUnassignTenant\x12%.rat'
    b'elimiter.v1.UnassignTenantRequest\x1a&.ratelimiter.'
    b'v1.UnassignTenantResponseb\x06proto3'
)

_lock = threading.Lock()
_pb2 = None


def load() -> SimpleNamespace:
    """The message classes (built once per process)."""
    global _pb2
    with _lock:
        if _pb2 is not None:
            return _pb2
        from google.protobuf import descriptor_pool, message_factory

        pool = descriptor_pool.DescriptorPool()
        pool.AddSerializedFile(SERIALIZED_FILE)
        fd = pool.FindFileByName(PROTO_FILE)
        get_class = getattr(message_factory, "GetMessageClass", None)
        if get_class is None:
            get_class = message_factory.MessageFactory(pool).GetPrototype
        ns = SimpleNamespace(SERVICE=SERVICE, DESCRIPTOR=fd)
        for name, desc in fd.message_types_by_name.items():
            setattr(ns, name, get_class(desc))
        _pb2 = ns
        return ns
