#!/usr/bin/env python3
"""Times the BN kernels (the statistics K7 and K8 and the passes
``bn_apply`` and ``bn_dx``) of this tree against another tree's, in one
call on one GPU.

    python3 tests/torch_port_bn_ab.py OTHER_ROOT [--rounds N]

OTHER_ROOT holds another version's ``chip_smoke.py`` and
``horovod_tpu_torch/`` (e.g. ``git archive`` of the parent commit, unpacked
under the git-ignored ``horovod_tpu_torch/ops/_build/``). Runs other, this,
this, other (N rounds) in separate processes on the runner of
``tests/torch_port_fwd_ab.py``, each calling its own tree's wrappers and
timing them with this tree's ``chip_smoke.time_ms`` (20 calls back to
back between CUDA events: ``_ms``) and ``chip_smoke.graph_ms`` (the same
calls replayed from a CUDA graph: ``_device_ms``):

- ``stats`` (K7, ``batch_norm_stats``), ``grad_stats`` (K8,
  ``batch_norm_grad_stats``), ``stats_terms`` (K7 with the forward's
  terms, ``batch_norm_stats_terms``, in trees that have it) and both
  passes at the ResNet-50 stem, 3,211,264 x 64 bf16, in f32 arithmetic
  (the resnet phase's calls), and K8 and the passes in lean mode with the
  ReLU or mask (resnet_lean's);
- the same calls in f32 at the bn_kernels phase's five Inception launches
  (``chip_smoke.INCEPTION_BN_SHAPES``);
- ``host_us``: microseconds of host time a wrapper call at 8,192 x 448,
  1,000 calls under ``time.perf_counter`` without synchronising, median of
  5;
- ``inception_bn_ms``: one forward and backward through 94
  ``FusedBatchNorm`` layers at Inception's launch shapes at batch 128
  (``chip_smoke.INCEPTION_BN_LAUNCHES``; K7 (with terms where the tree
  has them), K8 and both passes, no convolution), host clock to
  ``torch.cuda.synchronize()``, median of 5.

Each run saves every call's outputs at 36,992 x 192 (f32, and lean with
the ReLU or mask), and the runner reports, for each tree, whether every
run's equal that tree's first run's bit for bit (``bitwise``; two trees'
statistics may differ in their last bits, summed in another order).
Prints one ``AB {...}`` JSON line a run and the card's name and power
limit.
"""

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_port_fwd_ab as ab  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
STEM = (256 * 112 * 112, 64, (112, 112))
HOST_SHAPE = (128 * 8 * 8, 448)
SAVED_SHAPE = (128 * 17 * 17, 192)


def this_smoke():
    """This tree's chip_smoke.py, whatever tree the run imports."""
    spec = importlib.util.spec_from_file_location("chip_smoke_this",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(M, C, seed):
    """x, dy bf16 (M, C), x's f32 mean and rstd, gamma and beta."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(M, C, generator=g, device="cuda") * 2.0 + 0.5).to(
        torch.bfloat16)
    dy = torch.randn(M, C, generator=g, device="cuda").to(torch.bfloat16)
    var, mean = torch.var_mean(x.float(), 0, correction=0)
    gamma = torch.rand(C, generator=g, device="cuda") + 0.5
    beta = torch.randn(C, generator=g, device="cuda")
    return x, dy, mean, torch.rsqrt(var + 1e-5), gamma, beta


def calls(bn, M, C, seed, lean=False):
    """{kernel: a call of it} at (M, C): f32 arithmetic without the ReLU,
    or lean mode with it (K8 with the mask; no K7)."""
    x, dy, mean, rstd, gamma, beta = inputs(M, C, seed)
    a = gamma * rstd
    b = beta - mean * a
    dbeta, dgamma = bn.batch_norm_grad_stats(dy, x, mean, rstd)
    extra = (1, True, "lean") if lean else ()
    mask = (1, gamma, beta, "lean") if lean else ()
    out = {"grad_stats": lambda: bn.batch_norm_grad_stats(dy, x, mean, rstd,
                                                          *mask),
           "apply": lambda: bn.bn_apply(x, a, b, *extra),
           "dx": lambda: bn.bn_dx(dy, x, mean, rstd, gamma, beta, dbeta,
                                  dgamma, M, *extra)}
    if not lean:
        out["stats"] = lambda: bn.batch_norm_stats(x)
        if hasattr(bn, "batch_norm_stats_terms"):
            out["stats_terms"] = lambda: bn.batch_norm_stats_terms(
                x, gamma, beta, 1e-5)
    return out


def host_us(fn, n=1000, reps=5):
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def inception_bn_ms(bn, launches, batch=128, warmup=2, reps=5):
    """One forward and backward through a FusedBatchNorm layer for each of
    Inception's BN launches, each on its own channels_last bf16 input."""
    import torch
    layers = []
    for seed, ((hw, C), n) in enumerate(launches.items()):
        side = round(hw ** 0.5)
        g = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(n):
            x = torch.randn(batch, C, side, side, generator=g, device="cuda",
                            dtype=torch.bfloat16).to(
                                memory_format=torch.channels_last)
            layers.append((bn.FusedBatchNorm(C, eps=1e-3, device="cuda"),
                           x.requires_grad_(), torch.randn_like(x)))

    def step():
        ys = [mod(x) for mod, x, _ in layers]
        torch.autograd.backward(ys, [dy for _, _, dy in layers])
        torch.cuda.synchronize()
    for _ in range(warmup):
        step()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), len(layers)


def one(root, label, save=None):
    cs, _ = ab.load(root)
    this = this_smoke()
    from horovod_tpu_torch.ops import batch_norm as bn
    res = {"label": label, "root": str(root)}
    M, C, _ = STEM
    for tag, lean in (("stem", False), ("stem_lean_relu", True)):
        for name, fn in calls(bn, M, C, 1, lean).items():
            res["%s_%s_ms" % (name, tag)] = this.time_ms(fn)
            res["%s_%s_device_ms" % (name, tag)] = this.graph_ms(fn)
    for seed, (tag, (M, C, _, _)) in enumerate(
            this.INCEPTION_BN_SHAPES.items()):
        for name, fn in calls(bn, M, C, 10 + seed).items():
            res["%s_%s_ms" % (name, tag)] = this.time_ms(fn)
            res["%s_%s_device_ms" % (name, tag)] = this.graph_ms(fn)
    for name, fn in calls(bn, *HOST_SHAPE, 2).items():
        res["%s_host_us" % name] = host_us(fn)
    res["inception_bn_ms"], res["inception_bn_layers"] = inception_bn_ms(
        bn, this.INCEPTION_BN_LAUNCHES)
    if save:
        import torch
        outs = {}
        for tag, lean in (("f32", False), ("lean_relu", True)):
            for name, fn in calls(bn, *SAVED_SHAPE, 3, lean).items():
                got = fn()
                for i, t in enumerate(got if isinstance(got, tuple)
                                      else (got,)):
                    outs["%s_%s_%d" % (name, tag, i)] = t
        torch.save(outs, save)
    print("AB " + json.dumps(res), flush=True)


if __name__ == "__main__":
    ab.main(one=one, script=__file__, doc=__doc__, by_tree=True)
