"""The serve plane's model registry (docs/SERVE.md).

Counterpart of ``horovod_tpu/serve/model.py``. A serve model is two pure
functions over a flat dict of float32 leaves, what
:func:`horovod_tpu_torch.elastic.durable.load_leaves` hands back from a
checkpoint lineage (through :func:`extract_leaves`):

* ``init_leaves(dim, seed)``: deterministic initial numpy weights (what a
  replica serves before the first lineage checkpoint lands);
* ``forward(leaves, x)``: the batched forward pass, [B, D] -> [B, D],
  written once for numpy arrays and torch tensors alike (``@``, ``+`` and
  :func:`_relu`).

:func:`forward` runs it on numpy: the parity reference the load
generator and the tests recompute answers with. It never runs on the
card. :func:`make_forward` runs it as torch operations on a device, the
GPU unless the caller asks for the CPU: the leaves are uploaded once for
each weight set, and each call copies the batcher's frame to the device,
computes, and copies the result back. There is no fallback: a CUDA error
fails the batch (``MicroBatcher.run_batch`` answers it cause-named), and
without a GPU a forward asked for the default device raises
``CudaUnavailableError``.

The products run in float32 and need TF32 off in the calling process
(the replica turns it off when it starts): with TF32 the mlp at dim 2048
misses ``loadgen.check_response``'s atol of 1e-3.

Every response carries :func:`fingerprint` of the serving leaves: the
CRC32C chain over sorted leaf names and bytes. The rolling-swap e2e
asserts post-swap responses carry the NEW lineage's fingerprint, which
is how "provably computed from the new weights" is checked without
trusting a step counter someone could forget to bump.

Importing this module imports no torch: the load generator, which
recomputes answers with :func:`forward`, starts without it.
"""

import numpy as np

from horovod_tpu_torch.elastic import durable
from horovod_tpu_torch.elastic.state import _is_tensor

# Registered model -> (init_leaves, forward). The serving data path is
# model-agnostic: anything mapping a leaves dict + [B, D] batch to
# [B, D] outputs, on numpy arrays and on torch tensors, slots in here.
_REGISTRY = {}


def register_model(name, init_fn, forward_fn):
    _REGISTRY[name] = (init_fn, forward_fn)


def _relu(h):
    if isinstance(h, np.ndarray):
        return np.maximum(h, 0.0)
    return h.clamp_min(0.0)


def _affine_init(dim, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "w": rng.standard_normal((dim, dim)).astype(np.float32),
        "b": rng.standard_normal((dim,)).astype(np.float32),
    }


def _affine_forward(leaves, x):
    return x @ leaves["w"] + leaves["b"]


def _mlp_init(dim, seed=0):
    rng = np.random.RandomState(seed)
    hidden = 4 * dim
    return {
        "w0": (rng.standard_normal((dim, hidden)) /
               np.sqrt(dim)).astype(np.float32),
        "b0": np.zeros((hidden,), np.float32),
        "w1": (rng.standard_normal((hidden, dim)) /
               np.sqrt(hidden)).astype(np.float32),
        "b1": np.zeros((dim,), np.float32),
    }


def _mlp_forward(leaves, x):
    h = _relu(x @ leaves["w0"] + leaves["b0"])
    return h @ leaves["w1"] + leaves["b1"]


register_model("affine", _affine_init, _affine_forward)
register_model("mlp", _mlp_init, _mlp_forward)


def _entry(name):
    if name not in _REGISTRY:
        raise ValueError("unknown serve model %r (have: %s)"
                         % (name, sorted(_REGISTRY)))
    return _REGISTRY[name]


def init_leaves(name, dim, seed=0):
    return _entry(name)[0](dim, seed)


def forward(name, leaves, x):
    """The numpy forward: the parity reference the load generator and
    the tests recompute answers with."""
    return np.asarray(_entry(name)[1](leaves, np.asarray(x)))


def fingerprint(leaves):
    """CRC32C chain over sorted leaf names + bytes, hex8: the identity
    of a weight set on the response wire."""
    crc = 0
    for key in sorted(leaves):
        crc = durable.crc32c(key.encode("utf-8"), crc)
        # the array's own buffer (C order), not a copy of it
        crc = durable.crc32c(np.ascontiguousarray(leaves[key]), crc)
    return "%08x" % crc


def _host_array(leaf):
    """A lineage leaf as numpy: the port's checkpoints hold tensors (CPU
    tensors once loaded, bfloat16 ones too), the reference's numpy
    arrays."""
    if _is_tensor(leaf):
        return leaf.detach().float().numpy()
    return np.asarray(leaf)


def extract_leaves(raw, template):
    """Maps a raw lineage leaf dict (``load_leaves`` output, flattened
    paths like ``.w`` / ``.opt.0.mu``) onto a model's leaf names by
    basename match, so a TRAINING job's durable lineage serves directly,
    optimizer slots and step counters ignored. Returns the {name: float32
    array} dict or None when any model leaf is missing or
    shape-mismatched (the replica then keeps its current weights). A
    float32 leaf is taken as it is, not copied."""
    out = {}
    for want, ref in template.items():
        cands = sorted(
            (k for k in raw if k == want or str(k).endswith("." + want)),
            key=lambda k: (len(str(k)), str(k)))
        picked = None
        for k in cands:
            arr = _host_array(raw[k])
            if arr.shape == ref.shape:
                picked = np.asarray(arr, dtype=np.float32)
                break
        if picked is None:
            return None
        out[want] = picked
    return out


def resolve_device(device=None, slot=0):
    """The ``torch.device`` a forward runs on: ``device`` as given
    (``"cpu"``, ``"cuda:1"``, a ``torch.device``), else the GPU
    ``cuda:(slot mod torch.cuda.device_count())``, ``slot`` the replica's
    local slot on its host. A CUDA device on a machine without one raises
    ``CudaUnavailableError``."""
    import torch
    from horovod_tpu_torch.common.basics import CudaUnavailableError
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaUnavailableError(
            "the serve forward runs on the GPU unless asked for the CPU "
            "(device='cpu'; a replica: --device cpu or "
            "HVD_TPU_SERVE_DEVICE=cpu), and torch.cuda.is_available() is "
            "false")
    if device is None:
        dev = torch.device("cuda", int(slot) % torch.cuda.device_count())
    return dev


def make_forward(name, leaves, device=None):
    """Callable batch -> outputs over a FIXED leaves dict, on ``device``
    (see :func:`resolve_device`; None: ``cuda:0``). The leaves are
    uploaded once, as float32 tensors, straight from their host arrays
    (a float32 one is not copied on the host), and the upload has
    finished when this returns, so a weight swap builds the new callable
    off the request path and flips one reference: in-flight batches
    finish on the tensors the old one holds. Each call takes a float32
    numpy frame ([B, D]) and returns numpy."""
    fwd = _entry(name)[1]
    import torch
    dev = resolve_device(device)
    on_device = {}
    for k, v in leaves.items():
        host = np.ascontiguousarray(v, dtype=np.float32)
        if not host.flags.writeable:  # torch.from_numpy needs one
            host = host.copy()
        # copy=True: on the CPU too, the forward holds its own leaves
        on_device[k] = torch.from_numpy(host).to(dev, copy=True)
    if dev.type == "cuda":
        # the swap watcher's thread uploads while the batch loop computes
        # on the same stream: the new set is complete before it is
        # published
        torch.cuda.current_stream(dev).synchronize()

    def run(x):
        frame = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
        return fwd(on_device, frame.to(dev)).cpu().numpy()

    run.device = dev
    return run
