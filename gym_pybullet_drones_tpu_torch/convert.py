"""Carry parameters and state across from the JAX package as numpy arrays.

The JAX records' fields, read with ``np.asarray(getattr(record, field))``,
become the port's records here, so both packages compute from identical
inputs. The ``*_to_numpy`` functions read any record with the same field
names (the port's or the JAX package's), so one comparison serves both.
Batched (per-env) parameter records come across the same way, their leaves
with a leading env axis.

Policy weights come across as flax writes them: ``load_flax_msgpack`` reads a
``flax.serialization.to_bytes`` file (``checkpoints/*.msgpack``) with a
decoder of its own, ``save_flax_msgpack`` writes one with an encoder of its
own, and ``actor_critic_from_flax`` / ``actor_critic_to_flax`` map the tree
to and from the port's ``ActorCritic`` or ``CnnActorCritic``.
This module imports no JAX, flax or msgpack.
"""

import dataclasses
import struct

import numpy as np
import torch

from gym_pybullet_drones_tpu_torch._struct import resolve_device, resolve_dtype
from gym_pybullet_drones_tpu_torch.control.dsl_pid import DSLPIDParams, DSLPIDState
from gym_pybullet_drones_tpu_torch.core.dynamics import KinState
from gym_pybullet_drones_tpu_torch.core.params import DroneParams
from gym_pybullet_drones_tpu_torch.envs.base import AviaryState
from gym_pybullet_drones_tpu_torch.rl.ppo import ActorCritic, CnnActorCritic

_KIN = tuple(f.name for f in dataclasses.fields(KinState))
_CTRL = tuple(f.name for f in dataclasses.fields(DSLPIDState))
# The flat field names of an AviaryState: kinematics, last action, controller
# memory, RL action buffer and the substep counter.
AVIARY_STATE_FIELDS = _KIN + ("last_rpm",) + _CTRL + ("action_buffer", "step_count")


def _np(x) -> np.ndarray:
    """A writable numpy copy of a tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x)


def _tensor(v, dtype, device):
    v = np.array(v)  # a writable copy: JAX hands out read-only buffers
    if np.issubdtype(v.dtype, np.integer):
        return torch.as_tensor(v, device=device)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _record(cls, d, dtype, device):
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    return cls(**{f.name: _tensor(d[f.name], dtype, device) for f in dataclasses.fields(cls)})


def drone_params_from_numpy(d: dict, device=None, dtype=torch.float32) -> DroneParams:
    """DroneParams from {field: numpy array}; integer fields keep their type."""
    return _record(DroneParams, d, dtype, device)


def dsl_pid_params_from_numpy(d: dict, device=None, dtype=torch.float32) -> DSLPIDParams:
    """DSLPIDParams from {field: numpy array}."""
    return _record(DSLPIDParams, d, dtype, device)


def kin_state_from_numpy(d: dict, device=None, dtype=torch.float32) -> KinState:
    """KinState from {field: numpy array}."""
    return _record(KinState, d, dtype, device)


def aviary_state_from_numpy(d: dict, device=None, dtype=torch.float32) -> AviaryState:
    """AviaryState from the flat dict of ``AVIARY_STATE_FIELDS``."""
    dtype, device = resolve_dtype(dtype), resolve_device(device)
    t = lambda k: _tensor(d[k], dtype, device)
    return AviaryState(
        kin=KinState(**{k: t(k) for k in _KIN}),
        last_rpm=t("last_rpm"),
        ctrl=DSLPIDState(**{k: t(k) for k in _CTRL}),
        action_buffer=t("action_buffer"),
        step_count=torch.as_tensor(np.array(d["step_count"], dtype=np.int32),
                                   device=device),
    )


def record_to_numpy(record) -> dict:
    """{field: numpy array} of a flat parameter record (either package's)."""
    return {f.name: _np(getattr(record, f.name)) for f in dataclasses.fields(record)}


def aviary_state_to_numpy(state) -> dict:
    """The flat dict of ``AVIARY_STATE_FIELDS`` of an AviaryState (either package's)."""
    out = {k: _np(getattr(state.kin, k)) for k in _KIN}
    out.update({k: _np(getattr(state.ctrl, k)) for k in _CTRL})
    for k in ("last_rpm", "action_buffer", "step_count"):
        out[k] = _np(getattr(state, k))
    return out


# msgpack's fixed-width forms: first byte -> (struct format, byte count).
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8), 0xcc: (">B", 1), 0xcd: (">H", 2),
          0xce: (">I", 4), 0xcf: (">Q", 8), 0xd0: (">b", 1), 0xd1: (">h", 2),
          0xd2: (">i", 4), 0xd3: (">q", 8)}
_LEN = {1: ">B", 2: ">H", 4: ">I"}
# flax.serialization's ext types: 1 an ndarray, 3 a numpy scalar.
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A msgpack decoder for what ``flax.serialization.to_bytes`` writes:
    maps, arrays, str, bin, ints, floats, nil, bool and flax's ndarray and
    numpy-scalar ext types."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt, n):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, n):
        return self.unpack(_LEN[n], n)

    def ext(self, n):
        code = self.unpack(">b", 1)
        payload = _Reader(self.take(n))
        if code == _EXT_NDARRAY:
            shape, dtype, raw = payload.read()
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        if code == _EXT_NPSCALAR:  # packed as a 0-d ndarray
            shape, dtype, raw = payload.read()
            return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)[()]
        raise ValueError(f"unsupported msgpack ext type {code}")

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.take(b & 0x1f).decode()
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):  # bin 8 / 16 / 32
            return bytes(self.take(self.length(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):  # ext 8 / 16 / 32
            return self.ext(self.length(1 << (b - 0xc7)))
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xd4 <= b <= 0xd8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):  # str 8 / 16 / 32
            return self.take(self.length(1 << (b - 0xd9))).decode()
        if b in (0xdc, 0xdd):  # array 16 / 32
            return self.array(self.length(2 << (b - 0xdc)))
        if b in (0xde, 0xdf):  # map 16 / 32
            return self.map(self.length(2 << (b - 0xde)))
        raise ValueError(f"invalid msgpack byte 0x{b:02x}")

    def array(self, n):
        return [self.read() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def load_flax_msgpack(path) -> dict:
    """The nested dict of numpy arrays of a ``flax.serialization.to_bytes``
    file (what ``flax.serialization.msgpack_restore`` returns)."""
    with open(path, "rb") as fh:
        reader = _Reader(fh.read())
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


def _pack_length(out: bytearray, n: int, fix: int, fix_max: int, wide: tuple):
    """A msgpack length header: the fix form below ``fix_max``, else the
    first of ``wide``'s (first byte, length format) pairs that holds ``n``."""
    if n < fix_max:
        out.append(fix | n)
        return
    for first, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(first)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} is too large")


def _pack_int(out: bytearray, v: int):
    """An int in msgpack's smallest form: a fixint, else the first unsigned
    (v >= 0) or signed width that holds it."""
    if -32 <= v < 0x80:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    forms = (((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"), (0xcf, ">Q")) if v >= 0 else
             ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"), (0xd3, ">q")))
    for first, fmt in forms:
        try:
            packed = struct.pack(fmt, v)
        except struct.error:  # too wide for this form
            continue
        out.append(first)
        out += packed
        return
    raise ValueError(f"integer {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, payload: bytes):
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _pack_length(out, len(payload), 0, 0, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
    out += struct.pack(">b", code)
    out += payload


def _ndarray_payload(a: np.ndarray) -> bytes:
    """flax's ndarray encoding: the msgpack array (shape, dtype name, C bytes)."""
    out = bytearray([0x93])
    _pack_length(out, a.ndim, 0x90, 16, ((0xdc, ">H"), (0xdd, ">I")))
    for d in a.shape:
        _pack_int(out, int(d))
    _pack(out, a.dtype.name)
    raw = a.tobytes("C")
    _pack_length(out, len(raw), 0, 0, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
    out += raw
    return bytes(out)


def _pack(out: bytearray, x):
    """Append the msgpack form of ``x`` as ``flax.serialization.msgpack_serialize``
    writes it: str-keyed maps, ndarrays and numpy scalars as flax's ext types,
    and Python scalars; a tensor as its host ndarray."""
    if isinstance(x, dict):
        _pack_length(out, len(x), 0x80, 16, ((0xde, ">H"), (0xdf, ">I")))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"map key {k!r} is not a str")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise TypeError(f"cannot serialize an ndarray of dtype {x.dtype}")
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif isinstance(x, torch.Tensor):
        _pack(out, _np(x))
    elif x is None:
        out.append(0xc0)
    elif isinstance(x, bool):
        out.append(0xc3 if x else 0xc2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xcb)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode()
        _pack_length(out, len(raw), 0xa0, 32, ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
        out += raw
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} as flax msgpack")


def save_flax_msgpack(tree: dict, path) -> str:
    """Write ``tree`` (nested str-keyed dicts of numpy arrays, numpy scalars
    and Python scalars; tensors are copied to the host) byte for byte as
    ``flax.serialization.to_bytes`` writes it, so flax's ``from_bytes`` and
    ``load_flax_msgpack`` read it back. Returns ``path``."""
    out = bytearray()
    _pack(out, tree)
    with open(path, "wb") as fh:
        fh.write(out)
    return path


def _dense_layers(net):
    """The Linear layers of a policy in flax's ``Dense_i`` order: for a
    CnnActorCritic the 512 feature layer first, then (both kinds) the pi
    tower, the mean head, the vf tower and the value head."""
    heads = net.heads if isinstance(net, CnnActorCritic) else net
    first = [net.feat] if isinstance(net, CnnActorCritic) else []
    return first + [*heads.pi, heads.mean, *heads.vf, heads.value]


def actor_critic_from_flax(params: dict, device=None):
    """The port's policy holding a flax ``ActorCritic``'s or
    ``CnnActorCritic``'s parameters (``{"params": {"Dense_0": ...,
    "log_std": ...}}``; a tree with ``Conv_0`` is a CnnActorCritic).

    ``Dense_*`` in order: for the CNN, ``Dense_0`` the 512 feature layer
    (its input flattened in NHWC order, as the port's module flattens too);
    then h layers of the pi tower, the mean head, h of the vf tower and the
    value head. A flax kernel is (in, out), a Linear weight its transpose; a
    flax conv kernel is HWIO, a Conv2d weight OIHW. The widths, the drones and
    the frame stack come from the shapes."""
    tree = params["params"]
    cnn = "Conv_0" in tree
    dense = [tree[f"Dense_{i}"] for i in range(sum(k.startswith("Dense_") for k in tree))]
    heads = dense[1:] if cnn else dense
    h = (len(heads) - 2) // 2
    hidden = tuple(int(d["kernel"].shape[1]) for d in heads[:h])
    act_dim = int(heads[h]["kernel"].shape[1])
    if cnn:
        n_drones = int(heads[0]["kernel"].shape[0]) // CnnActorCritic.FEATURES
        in_channels = int(tree["Conv_0"]["kernel"].shape[2])
        net = CnnActorCritic(n_drones, in_channels, act_dim, hidden, device=device)
    else:
        net = ActorCritic(int(heads[0]["kernel"].shape[0]), act_dim, hidden, device=device)
    with torch.no_grad():
        if cnn:
            for i, conv in enumerate(net.convs):
                conv.weight.copy_(torch.as_tensor(
                    np.array(tree[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1)))
                conv.bias.copy_(torch.as_tensor(np.array(tree[f"Conv_{i}"]["bias"])))
        for layer, d in zip(_dense_layers(net), dense):
            layer.weight.copy_(torch.as_tensor(np.array(d["kernel"]).T))
            layer.bias.copy_(torch.as_tensor(np.array(d["bias"])))
        net.log_std.copy_(torch.as_tensor(np.array(tree["log_std"])))
    return net


def actor_critic_to_flax(module) -> dict:
    """The flax tree of ``actor_critic_from_flax``, as numpy arrays."""
    tree = {f"Dense_{i}": {"bias": _np(layer.bias), "kernel": _np(layer.weight).T.copy()}
            for i, layer in enumerate(_dense_layers(module))}
    if isinstance(module, CnnActorCritic):
        for i, conv in enumerate(module.convs):
            tree[f"Conv_{i}"] = {"bias": _np(conv.bias),
                                 "kernel": _np(conv.weight).transpose(2, 3, 1, 0).copy()}
    tree["log_std"] = _np(module.log_std)
    return {"params": tree}
