"""The wire codec of the ring collectives on two hand-written Hopper
kernels, and their plain PyTorch versions.

Counterpart of ``quantize_int8_jax`` and ``dequantize_int8_jax``
(``horovod_tpu/compression/__init__.py:228-251``) and of the bf16 cast of
``_ring_codec`` (``horovod_tpu/parallel/ring.py:533-557``), which XLA fuses
into each hop of the TPU's ring. Two kernels, in ``csrc/wire_codec.cu``,
each with a bf16 and an int8 mode:

- ``wire_encode(x, mode)``: an f32 chunk to its payload, ``(q int8 [N],
  scales f32 [N / 256])`` or ``(bf16 [N],)``;
- ``wire_decode_add(acc, payload, mode, add=True)``: the payload decoded
  and added into the f32 chunk ``acc`` in place (``add=False``: written
  over it), the reduce-scatter hop's ``chunk + dec(incoming)``.

N must be a multiple of ``BLOCK`` (256): the ring pads its chunks. Each
wrapper dispatches on where its tensors lie: on the CPU the plain version
runs, on CUDA the kernel runs or the wrapper raises. The kernels equal the
plain versions bit for bit (NaN where NaN): every operation of the plain
versions is one correctly rounded tensor op (a division by a tensor, not by
a Python scalar, which PyTorch's CUDA division turns into a multiply by the
reciprocal), and the kernels do the same op with its ``_rn`` intrinsic.
Each wrapper counts its kernel launches in ``.launches``.
"""

import ctypes

import torch

from horovod_tpu_torch.compression import BF16, BLOCK, NONE, resolve
from horovod_tpu_torch.ops import _build

_bound = {}


def _mode_id(mode):
    m = resolve(mode).mode
    if m == NONE:
        raise ValueError("wire mode none moves the f32 chunk as it is; the "
                         "codec takes 'bf16' or 'int8'")
    return m


# ------------------------------------------------------- plain versions


def quantize_int8_ref(x):
    """``quantize_int8_jax`` in torch ops, op for op: ``(q int8 [N], scales
    f32 [N / 256])`` of an f32 [N], N % 256 == 0. A block's scale is
    max|x| / 127, 0 for a block of zeros, NaN for a block holding a
    non-finite value (which then decodes non-finite)."""
    xb = x.view(-1, BLOCK)
    amax = xb.abs().amax(dim=1)  # NaN-propagating
    ok = torch.isfinite(amax)
    zero = torch.zeros_like(amax)
    scales = torch.where(
        ok, torch.where(amax > 0, amax / torch.full_like(amax, 127.0), zero),
        torch.full_like(amax, float("nan")))
    pos = ok & (scales > 0)
    ones = torch.ones_like(scales)
    inv = torch.where(pos, ones / torch.where(pos, scales, ones), zero)
    q = torch.clamp(torch.round(torch.nan_to_num(xb * inv[:, None])), -127,
                    127).to(torch.int8)
    return q.view(-1), scales


def dequantize_int8_ref(q, scales):
    """``dequantize_int8_jax``: f32 [N] of q int8 [N] and its scales."""
    return (q.view(-1, BLOCK).float() * scales[:, None]).view(-1)


def wire_encode_ref(x, mode):
    """The payload of an f32 chunk under ``mode`` (plain version)."""
    if _mode_id(mode) == BF16:
        return (x.to(torch.bfloat16),)
    return quantize_int8_ref(x)


def _decoded(payload, mode):
    if _mode_id(mode) == BF16:
        return payload[0].float()
    return dequantize_int8_ref(*payload)


def wire_decode_add_ref(acc, payload, mode, add=True):
    """``acc + dec(payload)`` (or ``dec(payload)``) into the f32 ``acc``, in
    place; returns ``acc`` (plain version)."""
    d = _decoded(payload, mode)
    if add:
        d = acc + d
    return acc.copy_(d)


# --------------------------------------------------------------- kernels


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> its argument types (csrc/wire_codec.cu)
_ARGTYPES = {
    # x, mode, out, scales, n, stream
    "hvd_wire_encode": [_P, _I, _P, _P, _L, _P],
    # payload, scales, mode, add, acc, n, stream
    "hvd_wire_decode_add": [_P, _P, _I, _I, _P, _L, _P],
}


def _entry(name):
    """(library, C function) of an entry point, built and bound once."""
    if name not in _bound:
        lib = _build.library("wire_codec")
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _bound[name] = (lib, fn)
    return _bound[name]


def _on_cpu(what, t):
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError("%s: tensors on %s; the kernels run on CUDA and the "
                         "plain version on the CPU" % (what, t.device))
    return False


def _check(what, name, t, dtype, n, device, aligned=True):
    if t.dtype != dtype or t.dim() != 1 or t.numel() != n:
        raise ValueError("%s: %s must be a 1-D %s tensor of %d elements, got "
                         "%s %s" % (what, name, dtype, n, t.dtype,
                                    tuple(t.shape)))
    if t.device != device or not t.is_contiguous():
        raise ValueError("%s: %s must be contiguous on %s" % (what, name,
                                                              device))
    if aligned and t.data_ptr() % 16:
        raise ValueError("%s: %s must start on a 16-byte boundary" % (what,
                                                                      name))


def _length(what, x):
    if x.dim() != 1 or x.numel() % BLOCK:
        raise ValueError("%s: a 1-D chunk of a multiple of %d elements, got "
                         "%s (the ring pads its chunks)"
                         % (what, BLOCK, tuple(x.shape)))
    return x.numel()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def wire_encode(x, mode):
    """The payload of the f32 chunk ``x`` [N] under ``mode`` ('bf16' or
    'int8'): ``(bf16 [N],)`` or ``(q int8 [N], scales f32 [N / 256])``."""
    what = "wire_encode"
    m = _mode_id(mode)
    n = _length(what, x)
    if x.dtype != torch.float32:
        raise ValueError("%s: the codec encodes float32, got %s" % (what,
                                                                    x.dtype))
    if _on_cpu(what, x):
        return wire_encode_ref(x, mode)
    _check(what, "x", x, torch.float32, n, x.device)
    if m == BF16:
        out = torch.empty(n, dtype=torch.bfloat16, device=x.device)
        scales = None
    else:
        out = torch.empty(n, dtype=torch.int8, device=x.device)
        scales = torch.empty(n // BLOCK, dtype=torch.float32, device=x.device)
    lib, fn = _entry("hvd_wire_encode")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), m, out.data_ptr(),
                 None if scales is None else scales.data_ptr(), n,
                 _stream(x.device))
    _build.check(lib, err, "hvd_wire_encode")
    wire_encode.launches += 1
    return (out,) if m == BF16 else (out, scales)


def wire_decode_add(acc, payload, mode, add=True):
    """Decodes ``payload`` (``wire_encode``'s, same mode) into the f32
    chunk ``acc`` [N] in place, ``acc + dec(payload)`` or, with
    ``add=False``, ``dec(payload)``; returns ``acc``."""
    what = "wire_decode_add"
    m = _mode_id(mode)
    n = _length(what, acc)
    if acc.dtype != torch.float32:
        raise ValueError("%s: the accumulator is float32, got %s"
                         % (what, acc.dtype))
    if len(payload) != (1 if m == BF16 else 2):
        raise ValueError("%s: a %s payload has %d tensors, got %d"
                         % (what, resolve(mode).name, 1 if m == BF16 else 2,
                            len(payload)))
    if _on_cpu(what, acc):
        return wire_decode_add_ref(acc, payload, mode, add)
    dev = acc.device
    _check(what, "acc", acc, torch.float32, n, dev)
    if m == BF16:
        _check(what, "payload", payload[0], torch.bfloat16, n, dev)
        scales = None
    else:
        _check(what, "q", payload[0], torch.int8, n, dev)
        scales = payload[1]
        _check(what, "scales", scales, torch.float32, n // BLOCK, dev,
               aligned=False)
    lib, fn = _entry("hvd_wire_decode_add")
    with torch.cuda.device(dev):
        err = fn(payload[0].data_ptr(),
                 None if scales is None else scales.data_ptr(), m, int(add),
                 acc.data_ptr(), n, _stream(dev))
    _build.check(lib, err, "hvd_wire_decode_add")
    wire_decode_add.launches += 1
    return acc


KERNEL_WRAPPERS = (wire_encode, wire_decode_add)


def launch_counts():
    """{wrapper: kernel launches}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts():
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()
