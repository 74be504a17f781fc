"""Compression of the tensors a collective moves.

Counterpart of ``horovod_tpu.jax.Compression`` and of the mode resolution
in ``horovod_tpu/compression/__init__.py``. Two families share the
namespace, as in the reference:

- tensor codecs (``Compression.none``, ``.fp16``, ``.bf16``) cast a
  floating tensor to the narrow type before the collective and back after
  it, so the reduction accumulates in the narrow type;
- wire modes (``Compression.wire_bf16``, ``.wire_int8``, the strings
  ``'bf16'`` and ``'int8'``, and ``HVD_TPU_COMPRESSION``) re-encode only
  the bytes each hop of an explicit ring moves, with an f32 accumulator.
  That ring and its quantize kernel are ROADMAP A4; selecting a wire mode
  raises ``NotImplementedError`` until then.
"""

import os

import torch

ENV_VAR = "HVD_TPU_COMPRESSION"
_WIDE = (torch.float32, torch.float64)


def _narrowing(dtype):
    class Codec:
        @staticmethod
        def compress(tensor):
            if tensor.dtype in _WIDE:
                return tensor.to(dtype), tensor.dtype
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor.to(ctx) if ctx is not None else tensor

    return Codec


class WireMode:
    """A wire compression mode (the reference's ``compression.Mode``)."""

    def __init__(self, name):
        self.name = name

    def __repr__(self):
        return "WireMode(%r)" % self.name


class Compression:
    """Tensor codecs and wire modes; ``compression=`` takes either."""

    class none:
        @staticmethod
        def compress(tensor):
            return tensor, None

        @staticmethod
        def decompress(tensor, ctx):
            return tensor

    fp16 = _narrowing(torch.float16)
    bf16 = _narrowing(torch.bfloat16)
    wire_bf16 = WireMode("bf16")
    wire_int8 = WireMode("int8")


_WIRE_NONE = WireMode("none")
_BY_KEY = {"": _WIRE_NONE, "none": _WIRE_NONE, "0": _WIRE_NONE,
           "bf16": Compression.wire_bf16, "1": Compression.wire_bf16,
           "int8": Compression.wire_int8, "2": Compression.wire_int8}


def codec(compression=None):
    """The tensor codec behind a ``compression=`` argument: a codec as it
    is; None (``HVD_TPU_COMPRESSION``, none when unset or unparseable, as
    in the reference) or ``'none'`` -> ``Compression.none``. A wire mode
    raises ``NotImplementedError`` (ROADMAP A4), and an unknown string
    ``ValueError``."""
    if hasattr(compression, "compress"):
        return compression
    if compression is None:
        mode = _BY_KEY.get(os.environ.get(ENV_VAR, "").strip().lower(),
                           _WIRE_NONE)
    elif isinstance(compression, WireMode):
        mode = compression
    else:
        key = str(compression).strip().lower()
        if key not in _BY_KEY:
            raise ValueError("unknown compression mode %r (expected 'none', "
                             "'bf16' or 'int8', or a tensor codec)"
                             % (compression,))
        mode = _BY_KEY[key]
    if mode is not _WIRE_NONE:
        raise NotImplementedError(
            "wire compression %r (the f32-accumulating ring and its "
            "quantize kernel) is ROADMAP A4; the tensor codecs "
            "Compression.fp16 and Compression.bf16 are ported" % mode.name)
    return Compression.none
