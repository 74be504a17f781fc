"""Rules of the PyTorch port as a package: it imports nothing of JAX or of
horovod_tpu, imports cleanly on a machine with no nvcc, triton or GPU,
and its entry points refuse to fall back to the CPU quietly."""

import ast
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")
# The package's sources; ops/_build/ holds build outputs, not sources.
PACKAGE_FILES = sorted(p for p in (ROOT / "horovod_tpu_torch").rglob("*.py")
                       if "_build" not in p.parts)
PORT_FILES = PACKAGE_FILES + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "torch_port_dp_worker.py",
    ROOT / "tests" / "torch_port_bn_worker.py",
    ROOT / "tests" / "torch_port_ring_worker.py",
    ROOT / "tests" / "torch_port_api_worker.py",
    ROOT / "tests" / "torch_port_wire_worker.py",
    ROOT / "tests" / "torch_port_zero_worker.py",
    ROOT / "tests" / "torch_port_parallel_worker.py",
    ROOT / "tests" / "torch_port_zoo_worker.py",
    ROOT / "tests" / "torch_port_planted_faults.py",
    ROOT / "tests" / "torch_port_fwd_ab.py",
    ROOT / "tests" / "torch_port_bwd_ab.py",
    ROOT / "tests" / "torch_port_bn_ab.py",
    ROOT / "tests" / "torch_port_bn_plans.py",
    ROOT / "tests" / "test_torch_port_cuda.py",
]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_forbidden_names_are_matched_exactly():
    assert _forbidden("horovod_tpu.ops") and _forbidden("jax.numpy")
    assert _forbidden("horovod_tpu") and _forbidden("flax.linen")
    assert not _forbidden("horovod_tpu_torch.ops")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_horovod_tpu_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, "%s imports %s" % (path.relative_to(ROOT), bad)


def test_package_imports_without_nvcc_triton_or_gpu(tmp_path):
    """Every module imports in a fresh process whose PATH holds no nvcc;
    nothing is built and neither JAX nor triton is loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
            ".__init__", "")
        for p in PACKAGE_FILES)
    code = (
        "import sys, importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'horovod_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "from horovod_tpu_torch.ops import _build\n"
        "assert not _build._libs\n" % mods)
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_missing_nvcc_is_a_named_error(monkeypatch, tmp_path):
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.nvcc()


def test_library_name_follows_the_sources():
    """An edited source gets a new library name, so a stale build is never
    loaded."""
    paths = [_build.library_path(s) for s in _build.SOURCES]
    assert len(set(paths)) == len(paths)
    a = paths[0]
    assert a.parent == _build.BUILD_DIR
    assert a.name.startswith("libflash_fwd.") and a.suffix == ".so"


@pytest.mark.parametrize("source", _build.SOURCES)
def test_every_source_exports_the_shared_error_symbol(source):
    """_build.library() binds one error-string symbol in every library: each
    source reaches csrc/hvd_error.cuh, which defines it, and no source
    defines a kernel-named one of its own."""
    header = (_build.CSRC / "hvd_error.cuh").read_text()
    assert 'extern "C" const char* %s(' % _build.ERROR_SYMBOL in header
    texts = [(_build.CSRC / (source + ".cu")).read_text()]
    for inc in re.findall(r'#include "([^"]+)"', texts[0]):
        texts.append((_build.CSRC / inc).read_text())
    assert any('#include "hvd_error.cuh"' in t for t in texts)
    assert not any(re.search(r"_error_string\(", t.replace(
        _build.ERROR_SYMBOL + "(", "")) for t in texts)


def _planted_faults():
    """FAULTS of tests/torch_port_planted_faults.py (a script, not a
    module of a package)."""
    path = ROOT / "tests" / "torch_port_planted_faults.py"
    spec = importlib.util.spec_from_file_location("planted_faults", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.FAULTS


@pytest.mark.parametrize("fault", sorted(_planted_faults()))
def test_every_planted_fault_anchors_once_in_its_source(fault):
    """The mutation check plants each fault after one anchor line; a
    redesigned kernel that loses or repeats the line would make the check
    stop, so each anchor occurs exactly once."""
    source, anchor, line, phases = _planted_faults()[fault]
    text = (ROOT / "horovod_tpu_torch" / source).read_text()
    assert text.count(anchor) == 1, (fault, source)
    assert line.endswith("\n") and phases


@pytest.mark.parametrize("fault", sorted(
    f for f, spec in _planted_faults().items() if spec[0].endswith(".py")))
def test_python_planted_faults_still_parse(fault):
    """A fault planted in a Python source must leave it valid Python, so
    that chip_smoke.py fails on the fault's numbers, not on a SyntaxError
    that any planted line would cause."""
    source, anchor, line, _ = _planted_faults()[fault]
    text = (ROOT / "horovod_tpu_torch" / source).read_text()
    ast.parse(text.replace(anchor, anchor + line))


def test_entry_points_without_a_gpu_raise_the_named_error():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from horovod_tpu_torch.models import ResNet50Lean, ResNet50PBN
    from horovod_tpu_torch.ops import (FusedBatchNorm, LeanBatchNorm,
                                       lean_batch_norm_train)
    from horovod_tpu_torch.ops import batch_norm as bn
    from horovod_tpu_torch.parallel import lm_loss, make_train_step
    with pytest.raises(hvd.CudaUnavailableError):
        hvd.init()
    for entry in (ResNet50PBN, ResNet50Lean):
        with pytest.raises(hvd.CudaUnavailableError):
            entry(num_classes=1000)
    for entry in (FusedBatchNorm, LeanBatchNorm):
        with pytest.raises(hvd.CudaUnavailableError):
            entry(64)
    # a function of the caller's tensors: on CPU tensors the plain
    # versions, no kernel
    before = bn.launch_counts()
    y, _, _ = lean_batch_norm_train(torch.ones(4, 3), torch.ones(3),
                                    torch.zeros(3), relu=True)
    assert y.device.type == "cpu" and bn.launch_counts() == before
    terms = bn.batch_norm_stats_terms(torch.ones(4, 3), torch.ones(3),
                                      torch.zeros(3), 1e-5, groups=2)
    assert all(t.device.type == "cpu" and t.shape == (2, 3) for t in terms)
    assert bn.launch_counts() == before
    assert not hvd.is_initialized()
    model = torch.nn.Linear(2, 2)
    with pytest.raises(hvd.CudaUnavailableError):
        make_train_step(model, lm_loss, torch.optim.SGD(model.parameters(),
                                                        lr=0.1))
    with pytest.raises(hvd.CudaUnavailableError):
        hvd.init(device="cuda")
    with pytest.raises(hvd.CudaUnavailableError):
        hvd.init(model_parallel=1)
    with pytest.raises(hvd.CudaUnavailableError):
        ResNet50Lean(num_classes=1000, bn_remat=True)
    with pytest.raises(hvd.CudaUnavailableError):
        bn.StockBatchNorm(64, group=hvd.WORLD)
    with pytest.raises(hvd.CudaUnavailableError):
        make_train_step(model, lm_loss, torch.optim.SGD(model.parameters(),
                                                        lr=0.1), zero1=True,
                        compression="int8")
    with pytest.raises(hvd.CudaUnavailableError):
        hvd.make_fsdp_train_step(model, lm_loss, torch.optim.Adam)
    assert not hvd.is_initialized()
    # the zoo and AGC (ROADMAP A6): the models are built on the GPU by
    # default; agc_clip is a function of the caller's tensors
    from horovod_tpu_torch.models import (VGG16, InceptionV3, MnistCNN,
                                          ResNet50GN, ResNet50NF,
                                          ResNet101NF, SkipGram)
    from horovod_tpu_torch.ops import agc_clip
    for entry in (VGG16, InceptionV3, MnistCNN, ResNet50GN, ResNet50NF,
                  ResNet101NF, SkipGram):
        with pytest.raises(hvd.CudaUnavailableError):
            entry()
    with pytest.raises(hvd.CudaUnavailableError):
        make_train_step(model, lm_loss, torch.optim.SGD(model.parameters(),
                                                        lr=0.1), agc=0.01)
    clipped = agc_clip({"w": torch.ones(2, 2)}, {"w": torch.ones(2, 2)})
    assert clipped["w"].device.type == "cpu"
    assert not hvd.is_initialized()
    # the codec wrappers: on CPU tensors their plain versions, no kernel
    from horovod_tpu_torch.ops import wire_codec
    before = wire_codec.launch_counts()
    payload = wire_codec.wire_encode(torch.ones(256), "int8")
    acc = wire_codec.wire_decode_add(torch.zeros(256), payload, "int8")
    assert torch.equal(acc, torch.ones(256))
    assert wire_codec.launch_counts() == before
    # the collectives run on the process group init() started, on the GPU
    # unless it was asked for the CPU: before init() they raise, naming it
    x = torch.ones(3)
    for call in (lambda: hvd.new_group([0]), lambda: hvd.reduce_scatter(x),
                 lambda: hvd.metric_average(1.0), hvd.assert_synchronized,
                 lambda: hvd.allreduce(x, group=hvd.WORLD),
                 lambda: hvd.ring_allreduce(x, compression="int8"),
                 lambda: hvd.ring_reduce_scatter(x),
                 lambda: hvd.ring_allgather(x),
                 lambda: hvd.allreduce(x, compression="int8"),
                 lambda: hvd.allreduce_sparse(torch.zeros(2).long(), x[:2]),
                 lambda: hvd.checkpoint.save("/nonexistent", {"x": x}),
                 lambda: hvd.checkpoint.restore("/nonexistent", {"x": x})):
        with pytest.raises(RuntimeError, match="hvd.init"):
            call()


def test_queries_before_init_raise():
    assert not hvd.is_initialized()
    with pytest.raises(RuntimeError, match="hvd.init"):
        hvd.rank()


def test_one_rank_cpu_group():
    hvd.init(device="cpu")
    try:
        assert (hvd.rank(), hvd.size(), hvd.local_rank(),
                hvd.local_size()) == (0, 1, 0, 1)
        assert hvd.device() == torch.device("cpu")
        x = torch.arange(4.0)
        assert torch.equal(hvd.allreduce(x), x)
        assert torch.equal(hvd.allgather(x), x)
        assert torch.equal(hvd.broadcast(x, 0), x)
    finally:
        hvd.shutdown()
    assert not hvd.is_initialized()


def test_what_is_not_ported_names_its_roadmap_item(monkeypatch):
    """The rank-subset init (A8) raises NotImplementedError naming its
    item. AGC (A6, ported) builds and clips; the wire compression modes and
    the sharded update (A4, ported) run at one rank: the wire modes are the
    identity there (the ring applies no codec to one rank), and the sharded
    optimizer is built; the tensor codecs run."""
    with pytest.raises(NotImplementedError, match="A8"):
        hvd.init(device="cpu", ranks=[0])
    assert not hvd.is_initialized()
    hvd.init(device="cpu")
    try:
        x = torch.arange(4.0)
        for mode in ("bf16", "int8", hvd.Compression.wire_bf16,
                     hvd.Compression.wire_int8):
            assert torch.equal(hvd.allreduce(x, compression=mode), x)
        monkeypatch.setenv("HVD_TPU_COMPRESSION", "int8")
        # the ring's chunk: the vector padded to a whole int8 block
        shard = hvd.reduce_scatter(x)
        assert shard.shape == (256,) and torch.equal(shard[:4], x)
        assert not shard[4:].any()
        monkeypatch.delenv("HVD_TPU_COMPRESSION")
        with pytest.raises(ValueError, match="unknown compression"):
            hvd.allreduce(x, compression="zstd")
        for codec in (None, "none", hvd.Compression.none,
                      hvd.Compression.fp16, hvd.Compression.bf16):
            assert torch.equal(hvd.allreduce(x, compression=codec), x)
        model = torch.nn.Linear(2, 2)
        sgd = torch.optim.SGD(model.parameters(), lr=0.1)
        assert isinstance(hvd.DistributedOptimizer(sgd, sharded_update=True),
                          hvd.ShardedDistributedOptimizer)
        monkeypatch.setenv("HVD_TPU_SHARDED_UPDATE", "1")
        assert isinstance(hvd.DistributedOptimizer(sgd),
                          hvd.ShardedDistributedOptimizer)
        monkeypatch.setenv("HVD_TPU_SHARDED_UPDATE", "0")
        # agc= builds, and step() clips the reduced gradient unit-wise:
        # each row of the Linear weight moves at most 0.01 of its norm
        clipped = hvd.DistributedOptimizer(sgd, model.named_parameters(),
                                           agc=0.01)
        assert clipped.agc == 0.01
        before = model.weight.detach().clone()
        (model(torch.ones(3, 2)) * 1e4).sum().backward()
        clipped.step()
        moved = (model.weight.detach() - before).norm(dim=1)
        # (moved is a difference of f32 weights near 0.5: ulps of 1e-4)
        assert (moved <= 0.1 * 0.01 * before.norm(dim=1) * (1 + 1e-3)).all()
        assert moved.min() > 0
        sgd.zero_grad()
        del clipped
        opt = hvd.DistributedOptimizer(sgd, compression="int8")
        assert opt._mode == "int8"
        hvd.DistributedOptimizer(sgd, compression=hvd.Compression.fp16,
                                 average=False, name_prefix="g")
    finally:
        hvd.shutdown()


def test_mesh_and_groups_at_one_rank(monkeypatch):
    """init(model_parallel=1) forms no mesh; k that does not divide the
    world raises the reference's error, before the env is persisted; a
    group over rank 0 runs every collective as world 1 implies."""
    monkeypatch.delenv("HVD_TPU_MODEL_PARALLEL", raising=False)
    hvd.init(device="cpu", model_parallel=1)
    try:
        assert hvd.model_parallel_size() == 1
        assert hvd.mesh_groups() == (None, None)
        g = hvd.new_group([0])
        assert (g.id, g.ranks, g.rank(), g.size(), 0 in g, 1 in g) == (
            1, (0,), 0, 1, True, False)
        assert g == hvd.ProcessGroup(1) and g != hvd.WORLD
        assert repr(hvd.WORLD) == "ProcessGroup(WORLD)"
        with pytest.raises(ValueError, match="duplicate"):
            hvd.new_group([0, 0])
        with pytest.raises(ValueError, match="world ranks"):
            hvd.new_group([1])
        x = torch.arange(5.0)
        assert torch.equal(hvd.allreduce(x, group=g, prescale_factor=2.0,
                                         postscale_factor=0.5), x)
        assert torch.equal(hvd.reduce_scatter(x.view(5, 1), group=g), x)
        assert hvd.metric_average(2.5) == 2.5
        seq, _ = hvd.collective_digest()
        hvd.assert_synchronized()
        assert hvd.collective_digest()[0] == seq + 1  # its own allgather
        hvd.init_distributed()
    finally:
        hvd.shutdown()
    with pytest.raises(RuntimeError, match="hvd.init"):
        hvd.init_distributed()
    with pytest.raises(ValueError, match="does not divide world size 1"):
        hvd.init(device="cpu", model_parallel=2)
    hvd.shutdown()
    assert os.environ["HVD_TPU_MODEL_PARALLEL"] == "1"
