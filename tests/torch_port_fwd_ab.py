#!/usr/bin/env python3
"""Times the flash forward kernels K1 and K4 of this tree against another
tree's, in one call on one GPU.

    python3 tests/torch_port_fwd_ab.py OTHER_ROOT [--rounds N]

OTHER_ROOT holds another version's ``chip_smoke.py`` and
``horovod_tpu_torch/`` (e.g. ``git archive`` of the parent commit, unpacked
under the git-ignored ``horovod_tpu_torch/ops/_build/``). Runs
other, this, this, other (N rounds) in separate processes, each timing with
its own tree's kernels and ``chip_smoke.time_ms``:

- K1 at the LM's shape, [8, 12, 2048, 64] causal bf16, beside SDPA's
  forward (a yardstick the port never calls), and the same without the
  causal mask;
- K4 at the sp phase's launch, [2, 12, 8192, 64] causal, zigzag chunks
  (0, 4096) on one rank (the timed repeats carry the state: the same tiles
  run), beside SDPA's causal forward at that shape; and K4 at one
  off-diagonal ring step, [2, 12, 2048, 64];
- K1 at the lc phase's launch, [2, 6, 8192, 128] with 2 kv heads, causal,
  and K4 at the lc_sp phase's launch (the same widths, zigzag chunks
  (0, 4096) on one rank, from a fresh state each call); where the tree has
  fused rotary, K1_rot and K4_rot there and K4_rot at the sp launch, each
  through its wrapper (a tree with the forward's rotary pass rotates q and
  k, then runs K1 or K4 on the copies).

Each run also saves K1_rot's out and lse at the lc launch and K4_rot's o,
m and l at the lc_sp launch, and the runner reports whether every run's
equal the first run's bit for bit (``bitwise``; with the largest
difference where not). Prints one ``AB {...}`` JSON line a run and the
card's name and power limit.
``tests/torch_port_bwd_ab.py`` runs the backward kernels on the same runner.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(root):
    """(chip_smoke, flash_attention) of the tree at ``root``, its kernels
    built."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    import horovod_tpu_torch.ops.flash_attention  # noqa: F401
    from horovod_tpu_torch.ops import _build
    _build.build()
    return cs, sys.modules["horovod_tpu_torch.ops.flash_attention"]


def one(root, label, save=None):
    import torch
    import torch.nn.functional as F
    cs, fa = load(root)
    res = {"label": label, "root": str(root)}
    q, k, v, _ = cs._inputs(dict(B=8, H=12, G=12, L=2048, D=64), 1)
    res["k1_ms"] = cs.time_ms(lambda: fa.flash_fwd(q, k, v, 0.125, True))
    # twice the pairs and no causal tail: the causal run's per-pair cost
    # against this one's shows what the tail of the grid costs
    res["k1_full_ms"] = cs.time_ms(lambda: fa.flash_fwd(q, k, v, 0.125,
                                                         False))
    res["sdpa_fwd_ms"] = cs.time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, scale=0.125))
    del q, k, v
    for tag, L, q_off, kv_off in (("k4_sp", 8192, (0, 4096), (0, 4096)),
                                  ("k4_off", 2048, (2048,), (0,))):
        q, k, v, _ = cs._inputs(dict(B=2, H=12, G=12, L=L, D=64), 2)
        o = torch.zeros(q.shape, device="cuda")
        m = torch.full(q.shape[:3], float("-inf"), device="cuda")
        l = torch.zeros(q.shape[:3], device="cuda")
        res[tag + "_ms"] = cs.time_ms(lambda: fa.flash_ring_step(
            q, k, v, o, m, l, q_off, kv_off, 0.125, True))
        if tag == "k4_sp":
            res["sdpa_sp_fwd_ms"] = cs.time_ms(
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True,
                                                       scale=0.125))
            if rotary(fa):
                res["k4_rot_sp_ms"] = cs.time_ms(lambda: fa.flash_ring_step(
                    q, k, v, o, m, l, q_off, kv_off, 0.125, True,
                    rotary_base=10000.0))
    del q, k, v, o, m, l
    q, k, v, _ = cs._inputs(dict(B=2, H=6, G=2, L=8192, D=128), 3)
    scale = 128 ** -0.5
    offs, rb = (0, 4096), 10000.0

    def k4(*rot):
        o = torch.zeros(q.shape, device="cuda")
        m = torch.full(q.shape[:3], float("-inf"), device="cuda")
        l = torch.zeros(q.shape[:3], device="cuda")
        return fa.flash_ring_step(q, k, v, o, m, l, offs, offs, scale, True,
                                  *rot)
    res["k1_lc_ms"] = cs.time_ms(lambda: fa.flash_fwd(q, k, v, scale, True))
    res["k4_lcsp_ms"] = cs.time_ms(k4)
    if rotary(fa):
        res["k1_rot_lc_ms"] = cs.time_ms(lambda: fa.flash_fwd(
            q, k, v, scale, True, rotary_base=rb))
        res["k4_rot_lcsp_ms"] = cs.time_ms(lambda: k4(rb))
        if save:
            torch.save(dict(zip(("out", "lse", "o", "m", "l"),
                                (*fa.flash_fwd(q, k, v, scale, True, rb),
                                 *k4(rb)))), save)
    print("AB " + json.dumps(res), flush=True)


def bitwise(paths):
    """Whether each saved run's tensors equal the first run's bit for bit:
    {name: True, or the largest |difference|}."""
    import torch
    runs = [torch.load(p) for p in paths]
    report = {}
    for name, first in runs[0].items():
        diffs = [(r[name].float() - first.float()).abs().nan_to_num(0.0)
                 .max().item() for r in runs[1:]
                 if not torch.equal(r[name], first)]
        report[name] = max(diffs) if diffs else True
    return report


def rotary(fa):
    """Whether the tree's kernels take fused rotary."""
    import inspect
    return "rotary_base" in inspect.signature(fa.flash_fwd).parameters


def main(one=one, script=__file__, doc=__doc__, compare=True, by_tree=False):
    """Runs ``one`` of ``script`` in turns, other/this/this/other;
    ``compare``: each run saves its outputs, and the runner holds them
    against the first run's (``bitwise``), or with ``by_tree`` against the
    first run of the same tree (``{"other": ..., "this": ...}``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("other", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--one", metavar="LABEL", help=argparse.SUPPRESS)
    ap.add_argument("--save", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(Path(args.other).resolve(), args.one,
            *([args.save] if args.save else []))
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    other = Path(args.other).resolve()
    order = []
    for _ in range(args.rounds):
        order += [(other, "other"), (ROOT, "this"), (ROOT, "this"),
                  (other, "other")]
    saved = []
    for i, (root, label) in enumerate(order):
        cmd = [sys.executable, script, str(root), "--one", label]
        if compare:
            saved.append(ROOT / "horovod_tpu_torch" / "ops" / "_build" /
                         ("ab_run%d.pt" % i))
            cmd += ["--save", str(saved[-1])]
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        lines = [x for x in run.stdout.splitlines() if x.startswith("AB ")]
        if run.returncode != 0 or not lines:
            sys.exit("%s run failed (%d):\n%s" % (label, run.returncode,
                                                  run.stderr[-3000:]))
        print(lines[0], flush=True)
    if by_tree:
        report = {}
        for label in ("other", "this"):
            mine = [p for p, (_, lab) in zip(saved, order)
                    if lab == label and p.exists()]
            if len(mine) > 1:
                report[label] = bitwise(mine)
        print("AB bitwise " + json.dumps(report), flush=True)
        return
    saved = [p for p in saved if p.exists()]
    if len(saved) > 1:
        print("AB bitwise " + json.dumps(bitwise(saved)), flush=True)


if __name__ == "__main__":
    main()
