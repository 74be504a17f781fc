"""Compression of the tensors a collective moves.

Counterpart of ``horovod_tpu.jax.Compression`` and of
``horovod_tpu/compression/__init__.py``. Two families share the
namespace, as in the reference:

- tensor codecs (``Compression.none``, ``.fp16``, ``.bf16``) cast a
  floating tensor to the narrow type before the collective and back after
  it, so the reduction accumulates in the narrow type;
- wire modes (``Compression.wire_bf16``, ``.wire_int8``, the strings
  ``'none'``, ``'bf16'`` and ``'int8'``, and ``HVD_TPU_COMPRESSION``)
  re-encode only the bytes each hop of the explicit ring moves
  (``parallel.ring.ring_allreduce``), with an f32 accumulator. bf16 rounds
  each element to nearest even; int8 quantizes each block of ``BLOCK``
  elements against one f32 scale, ``max|x| / 127``, carried beside the
  payload. Only float32 tensors compress: any other dtype rides ``none``.

``codec()`` maps a ``compression=`` argument to its tensor codec,
``wire_mode()`` to its wire mode; a tensor codec has wire mode none and a
wire mode has the no-op codec. The numpy quantizers below
(``quantize_int8``, ``dequantize_int8``, ``bf16_roundtrip``) are copies of
the reference's, kept for API parity: host code can see what a wire hop
does to an array without a device. The ring runs the codec kernels of
``ops/wire_codec.py`` instead; the tests hold both to the reference's.
"""

import os

import numpy as np
import torch

ENV_VAR = "HVD_TPU_COMPRESSION"
# wire mode ids (native/compression.h CompressionMode in the reference)
NONE, BF16, INT8 = 0, 1, 2
# elements per int8 block, one f32 scale each (kCompressionBlock)
BLOCK = 256
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
    """A wire compression mode (the reference's ``compression.Mode``):
    ``mode`` is its id, ``name`` its string. Equal to its id, its name and
    any mode of the same id."""

    __slots__ = ("mode", "name")

    def __init__(self, mode, name):
        self.mode = mode
        self.name = name

    def __repr__(self):
        return "WireMode(%r)" % self.name

    def __eq__(self, other):
        if isinstance(other, WireMode):
            return self.mode == other.mode
        if isinstance(other, str):
            return self.name == other
        if isinstance(other, int):
            return self.mode == other
        return NotImplemented

    def __hash__(self):
        return hash(self.mode)


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
    wire_bf16 = WireMode(BF16, "bf16")
    wire_int8 = WireMode(INT8, "int8")


_WIRE_NONE = WireMode(NONE, "none")
_BY_KEY = {None: _WIRE_NONE, "": _WIRE_NONE, "none": _WIRE_NONE,
           "0": _WIRE_NONE, NONE: _WIRE_NONE,
           "bf16": Compression.wire_bf16, "1": Compression.wire_bf16,
           BF16: Compression.wire_bf16,
           "int8": Compression.wire_int8, "2": Compression.wire_int8,
           INT8: Compression.wire_int8}


def default_mode():
    """The job-wide wire mode from ``HVD_TPU_COMPRESSION``: none when unset
    or unparseable (a typo must not quantize)."""
    value = os.environ.get(ENV_VAR, "").strip().lower()
    return _BY_KEY.get(value, _WIRE_NONE)


def resolve(spec):
    """The ``WireMode`` of a ``compression=`` value: None defers to the env
    default; a string, an id or a mode maps directly. A tensor codec
    raises ``TypeError`` (it belongs to ``codec()``), an unknown value
    ``ValueError``."""
    if isinstance(spec, WireMode):
        return spec
    if spec is None:
        return default_mode()
    if hasattr(spec, "compress"):
        raise TypeError(
            "legacy codec objects (%r) belong to the framework binding "
            "layer; pass 'none'/'bf16'/'int8' (or Compression.<mode>) "
            "for wire compression" % (spec,))
    key = spec.lower().strip() if isinstance(spec, str) else spec
    try:
        return _BY_KEY[key]
    except (KeyError, TypeError):
        raise ValueError("unknown compression mode %r (expected 'none', "
                         "'bf16' or 'int8', or a tensor codec)" % (spec,))


def resolve_wire_arg(compression, none_codec=Compression.none):
    """The wire mode of a ``compression=`` argument under the sharded
    update: a tensor codec is rejected (it would change the dtype the
    shard-local optimizer sees), except the no-op ``none_codec``, which
    defers to ``HVD_TPU_COMPRESSION`` as passing nothing does."""
    if compression is not None and hasattr(compression, "compress"):
        if none_codec is None or compression is not none_codec:
            raise ValueError(
                "sharded_update takes wire compression modes "
                "('none'/'bf16'/'int8'), not legacy codec objects")
        compression = None
    return resolve(compression)


def codec(compression=None):
    """The tensor codec behind a ``compression=`` argument: a codec as it
    is, and ``Compression.none`` for a wire mode, a string or None (the
    wire mode then does the work, ``wire_mode()``)."""
    if hasattr(compression, "compress"):
        return compression
    resolve(compression)  # an unknown value raises here
    return Compression.none


def wire_mode(compression=None):
    """The wire mode behind a ``compression=`` argument: none for a tensor
    codec, else ``resolve(compression)``."""
    if hasattr(compression, "compress"):
        return _WIRE_NONE
    return resolve(compression)


def chunk_length(size, n):
    """Elements of each rank's chunk when the ring splits a flat vector of
    ``size`` over n ranks: ``ceil(ceil(size / n) / BLOCK) * BLOCK``, the
    int8 block padding in every mode, so a mode change never changes a
    shard's shape."""
    c = -(-int(size) // n)
    return -(-c // BLOCK) * BLOCK


def wire_bytes(count, mode):
    """Bytes that ``count`` f32 elements take on the wire under ``mode``."""
    mode = resolve(mode)
    if mode.mode == BF16:
        return 2 * count
    if mode.mode == INT8:
        return 4 * (-(-count // BLOCK)) + count
    return 4 * count


# --- the reference's numpy quantizers (API parity; the ring does not
# --- call them) ----------------------------------------------------------


def quantize_int8(x, block=BLOCK):
    """Block-scaled int8 quantization of a float array: ``(q, scales)``, q
    int8 with ``x.size`` elements, one f32 ``max|block| / 127`` a block
    (the last may be short). Symmetric range [-127, 127]. A block holding
    a non-finite value gets a NaN scale, so it decodes non-finite."""
    flat = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    n = flat.size
    nblocks = (n + block - 1) // block
    padded = np.zeros(nblocks * block, np.float32)
    padded[:n] = flat
    blocks = padded.reshape(nblocks, block)
    with np.errstate(invalid="ignore", over="ignore"):
        amax = np.max(np.abs(blocks), axis=1)  # NaN-propagating max
        scales = np.where(np.isfinite(amax),
                          np.where(amax > 0, amax / 127.0, 0.0),
                          np.float32(np.nan)).astype(np.float32)
        finite_scale = np.where(np.isfinite(scales) & (scales > 0),
                                scales, 1.0)
        inv = np.where(np.isfinite(scales) & (scales > 0),
                       1.0 / finite_scale, 0.0)
        q = np.clip(np.rint(np.nan_to_num(blocks * inv[:, None])),
                    -127, 127).astype(np.int8)
    return q.reshape(-1)[:n], scales


def dequantize_int8(q, scales, block=BLOCK):
    """Inverse of ``quantize_int8`` (up to the codec's rounding)."""
    flat = np.ascontiguousarray(q, dtype=np.int8).reshape(-1)
    n = flat.size
    nblocks = (n + block - 1) // block
    padded = np.zeros(nblocks * block, np.int8)
    padded[:n] = flat
    out = padded.reshape(nblocks, block).astype(np.float32) * \
        np.asarray(scales, np.float32)[:, None]
    return out.reshape(-1)[:n]


def bf16_roundtrip(x):
    """f32 -> bfloat16 (round to nearest even) -> f32 in numpy bit
    arithmetic: what one bf16 hop does to a value. A NaN stays a NaN."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    is_nan = (bits & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    lsb = (bits >> 16) & 1
    with np.errstate(over="ignore"):
        rounded = (bits + 0x7FFF + lsb) & np.uint32(0xFFFF0000)
    quiet_nan = ((bits >> 16) | np.uint32(0x40)).astype(np.uint32) << 16
    return np.where(is_nan, quiet_nan, rounded).astype(
        np.uint32).view(np.float32)
