#!/usr/bin/env python3
"""Mutation check of chip_smoke.py's kernel and gradient checks (one GPU).

    python3 tests/torch_port_planted_faults.py [fault ...]   # default: all

For each planted fault below, copies ``chip_smoke.py`` and
``horovod_tpu_torch/`` into ``horovod_tpu_torch/ops/_build/planted_<fault>/``
(git-ignored), plants the fault in the copy's CUDA source (or, for the
rotary faults of autograd and of the ring's rotation, its Python source),
and runs ``chip_smoke.py --only <phase>`` there for the kernel phase and
the model phase that the faulty kernel is on (kernels and train for the
flash kernels, bn_kernels and resnet for the BN kernels), or for the ring
kernels the ring_kernels phase, whose 4-rank ring carries state and
offsets that the one-rank sp phase does not; for the rotary faults the
kernels phase (or ring_kernels, for the ring's rotation and
counter-rotation); for the faults of the data-parallel API the api phase,
the train phase (the overlapped optimizer) or resnet_lean (bn_remat);
for the wire codec's faults the wire_kernels phase (the zero1 phase runs
one rank, where the ring applies no codec); for the MoE's faults (Python,
in ``parallel/expert.py``) the moe phase.
Every run must fail.
Prints the readings each run logged (errors against the plain versions,
the gradient gaps, the first losses) and exits 1 if a planted fault passed
a check.
"""

import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

FLASH_PHASES = ("kernels", "train")
BN_PHASES = ("bn_kernels", "resnet")
LEAN_PHASES = ("bn_kernels", "resnet_lean")
RING_PHASES = ("ring_kernels",)
ROT_PHASES = ("kernels",)
WIRE_PHASES = ("wire_kernels",)
# the statistics' row loop (K7, K8)
BN_ROW_LOOP = ("    for (long long r = rows.begin + ty; r < rows.end; r += U * "
               "ty_n) {\n")
# the normalize pass's y = x * a + b on a lane pair, and its ReLU
BN_APPLY_Y = "        P t = A::add(A::mul(v[j], va[j]), vb[j]);\n"
BN_APPLY_RELU = "        if (RELU) t = A::relu(t);\n"
# K2's and K3's scores, masked and before the exponentials
BWD_SCORES = "        const float* st = stats + stage * Tile::kStats;\n"
# The ring's epilogue in flash_bwd.cu (K5, K6): the carried sums' rows,
# and K5's add of its step's dQ to them
RING_SUMS = ("    float* sum1 = static_cast<float*>(p.out1) + b * p.s1.b + hb "
             "* p.s1.h;\n")
RING_DQ_ADD = "    add_rows<D>(sum1, p.s1.l, acc1, row0, n_own, tc);\n"
# fault -> (source under horovod_tpu_torch/, the line after which it goes,
# the line planted, the chip_smoke.py phases that must fail)
FAULTS = {
    # K1 skips key tile 1 for the q tiles from row 1024 on (its scores
    # count as masked)
    "fwd_skip_tile": (
        "ops/csrc/flash_fwd.cu",
        "      wgmma_wait<0>();\n      fence_operands(s);\n",
        "      if (!kRing && m0 >= 1024 && j == 1)\n"
        "        for (int e = 0; e < kFwdN / 2; ++e) s[e] = -INFINITY;\n",
        FLASH_PHASES),
    # K2 skips key tile 1 for the q tiles from row 1024 on (its scores
    # count as masked)
    "dq_skip_tile": (
        "ops/csrc/flash_bwd.cu", BWD_SCORES,
        "        if (!kDkv && m0 >= 1024 && j == 1)\n"
        "          for (int e = 0; e < kN / 2; ++e) x[e] = -INFINITY;\n",
        FLASH_PHASES),
    # K3 skips the second q tile it visits for the key tiles from row 1024
    # on
    "dkv_skip_tile": (
        "ops/csrc/flash_bwd.cu", BWD_SCORES,
        "        if (kDkv && m0 >= 1024 && j == j_first + 1)\n"
        "          for (int e = 0; e < kN / 2; ++e) x[e] = -INFINITY;\n",
        FLASH_PHASES),
    # K8 skips the last chunk of rows (the last row split's block)
    "bn_grad_skip_rows": (
        "ops/csrc/batch_norm.cu", BN_ROW_LOOP,
        "      if (GRAD && gridDim.x > 1 && blockIdx.x + 1 == gridDim.x) "
        "break;\n", BN_PHASES),
    # K7 drops the last tile of channels (the last VEC channels)
    "bn_stats_drop_channels": (
        "ops/csrc/batch_norm.cu", BN_ROW_LOOP,
        "      if (!GRAD && c0 + VEC >= C) break;\n", BN_PHASES),
    # K8's ReLU mask inverted: dy counts where the pre-activation is <= 0
    "bn_grad_mask_inverted": (
        "ops/csrc/batch_norm.cu",
        "            if (mask && !(pre_of<RT>(xh, ga[j], be[j]) > 0.f)) dm = "
        "0.f;\n",
        "            if (mask) dm = pre_of<RT>(xh, ga[j], be[j]) > 0.f ? 0.f : "
        "rnd<RT>(d[j]);\n", LEAN_PHASES),
    # the statistics' last block leaves split 0 of its tile out of the sums
    "bn_stats_last_block_skips_split0": (
        "ops/csrc/batch_norm.cu",
        "        if (s < p.splits) w[k] = __ldcg(all + (long long)s * n4 + "
        "i);\n",
        "        if (s == 0) w[k] = make_float4(0.f, 0.f, 0.f, 0.f);\n",
        ("bn_kernels",)),
    # the statistics' last block never sets its tile's counter back: a
    # first call is right, the next draws no last ticket
    "bn_stats_ticket_not_reset": (
        "ops/csrc/batch_norm.cu", "  if (threadIdx.x == 0) *ticket = 0u;\n",
        "  if (threadIdx.x == 0) *ticket = (unsigned)p.splits;\n",
        BN_PHASES),
    # K7's terms with b = beta + mean * a
    "bn_stats_terms_b_sign": (
        "ops/csrc/batch_norm.cu", "      out[4 * plane + c] = b;\n",
        "      out[4 * plane + c] = __fadd_rn(value(p.beta, g, c), "
        "__fmul_rn(mean, a));\n", BN_PHASES),
    # the statistics' split drops the second half of each group's last
    # split (the group's last chunk of rows)
    "bn_stats_split_drops_group_tail": (
        "ops/csrc/batch_norm.cu",
        "  Rows rows = split_rows(p.Mg, p.splits);\n",
        "  if (blockIdx.x % p.splits + 1 == p.splits)\n"
        "    rows.end -= (rows.end - rows.begin) / 2;\n", ("bn_kernels",)),
    # the normalize pass drops the shift b on the last tile of channels
    "bn_apply_shift_last_tile": (
        "ops/csrc/batch_norm.cu", BN_APPLY_Y,
        "        if (c0 + VEC >= C) t = A::mul(v[j], va[j]);\n", BN_PHASES),
    # the normalize pass leaves the fused ReLU out on the last tile of
    # channels
    "bn_apply_relu_last_tile": (
        "ops/csrc/batch_norm.cu", BN_APPLY_RELU,
        "        if (RELU && c0 + VEC >= C) t = A::add(A::mul(v[j], va[j]), "
        "vb[j]);\n", LEAN_PHASES),
    # the normalize pass takes the next ghost group's a and b (the
    # resnet_lean phase's ghost-BN gradient check must see it)
    "bn_apply_next_group": (
        "ops/csrc/batch_norm.cu",
        "    s[width + i] = from_float<RT>(value(b, rows.g, c));\n",
        "    s[i] = from_float<RT>(value(a, (rows.g + 1) % (gridDim.x / "
        "splits), c));\n    s[width + i] = from_float<RT>(value(b, (rows.g "
        "+ 1) % (gridDim.x / splits), c));\n",
        LEAN_PHASES),
    # the dx pass drops the dgamma term on the last tile of channels; only
    # bn_kernels sees it: the resnet phase's float32 gradient gap read
    # 0.0446 against its 0.05 (a term of dgamma / M on 8 of 64 or more
    # channels)
    "bn_dx_drop_dgamma_last_tile": (
        "ops/csrc/batch_norm.cu",
        "  term_pairs<RT, VEC>(mine + 4 * width, c2);\n",
        "  if (c0 + VEC >= C)\n    for (int j = 0; j < NP; ++j) c2[j] = "
        "A::of(make_float2(0.f, 0.f));\n", ("bn_kernels",)),
    # the dx pass scales the last tile of channels by rstd, not gamma * rstd
    "bn_dx_scale_last_tile": (
        "ops/csrc/batch_norm.cu",
        "  term_pairs<RT, VEC>(mine + 2 * width, k);\n",
        "  if (c0 + VEC >= C)\n    for (int j = 0; j < NP; ++j) k[j] = "
        "rs[j];\n", BN_PHASES),
    # the dx pass ignores the ReLU mask on the last tile of channels
    "bn_dx_mask_last_tile": (
        "ops/csrc/batch_norm.cu",
        "    term_pairs<RT, VEC>(mine + kBe * width, be);\n",
        "    if (c0 + VEC >= C)\n      for (int j = 0; j < NP; ++j) {\n"
        "        ga[j] = A::of(make_float2(0.f, 0.f));\n        be[j] = "
        "A::of(make_float2(1.f, 1.f));\n      }\n", LEAN_PHASES),
    # the dx pass builds c1 from the row count plus one (an off-by-one
    # reciprocal)
    "bn_dx_count_off_by_one": (
        "ops/csrc/batch_norm.cu",
        "        from_float<RT>(__fmul_rn(value(in.t[kDbeta], g, c), "
        "in.inv));\n",
        "    col[3 * width] = from_float<RT>(__fmul_rn(value(in.t[kDbeta], g, "
        "c), __frcp_rn(__frcp_rn(in.inv) + 1.f)));\n", ("bn_kernels",)),
    # the passes' row split drops the last rows of each group that an
    # uneven split leaves (every split Mg / splits rows, rounded down)
    "bn_pass_drops_last_rows": (
        "ops/csrc/batch_norm.cu",
        "  long long end = g * Mg + Mg * (s + 1) / splits;\n",
        "  end = begin + Mg / splits;\n", ("bn_kernels",)),
    # K4 ignores the carried running max, starting it from -inf
    "ring_fwd_drop_carried_m": (
        "ops/csrc/flash_fwd.cu",
        "      m_run[r] = valid ? p.m[row_base + rows[r]] * kLog2e : -INFINITY;"
        "\n",
        "      m_run[r] = -INFINITY;\n", RING_PHASES),
    # K5 drops dq_in, the dq carried from the earlier ring steps: it
    # writes this step's sum over it
    "ring_dq_drop_carried": (
        "ops/csrc/flash_bwd.cu", RING_DQ_ADD,
        "    if (!kDkv) store_rows<D, float>(sum1, p.s1.l, acc1, row0, n_own, "
        "tc, true);\n", RING_PHASES),
    # K5's warpgroups that saw no tile store zeros over the carried dq
    # (K2's epilogue); in the 4-rank zigzag ring a 192-row block of rank 0
    # straddles its q chunks 0 and 7, and the rows in chunk 0 see no key of
    # ranks 1-3
    "ring_dq_zero_unseen": (
        "ops/csrc/flash_bwd.cu", RING_SUMS,
        "    if (!kDkv && !live) store_rows<D, float>(sum1, p.s1.l, acc1, "
        "row0, n_own, tc, false);\n", RING_PHASES),
    # K6 gives every key row chunk 0's offset in its masks (zigzag shards
    # go wrong)
    "ring_dkv_chunk0_offset": (
        "ops/csrc/flash_bwd.cu",
        "    row_pos[r] = pos_of(kDkv ? p.kc : p.qc, row0 + 8 * r);\n",
        "  for (int r = 0; kDkv && r < 2; ++r) row_pos[r] = p.kc.off0 + row0 "
        "+ 8 * r;\n", RING_PHASES),
    # flash_attention's autograd saves the unrotated k for the backward,
    # whose K2_rot and K3_rot then read q rotated and k not
    "rot_saves_unrotated_k": (
        "ops/flash_attention.py",
        "        out, lse = _forward(qr, kr, v, scale, causal, rotary_base)\n",
        "        kr = k\n", ROT_PHASES),
    # K2_rot counter-rotates its dQ twice
    "rot_dq_unrotate_twice": (
        "ops/csrc/flash_bwd.cu",
        "    if (kRot && live) unrotate_rows<D>(acc1, row0, n_own, own_c, "
        "p.rope, tc);\n",
        "    if (kRot && live && !kDkv) unrotate_rows<D>(acc1, row0, n_own, "
        "own_c, p.rope, tc);\n", ROT_PHASES),
    # the rotary pass gives the rows of a zigzag shard's second chunk the
    # positions that follow its first chunk (off0 + r): one chunk's are
    # right, and so is a one-rank shard (0, L/2), whose chunks adjoin
    "rope_zigzag_chunk0": (
        "ops/csrc/rope.cu", "  int pos = pos_of(c, l);\n",
        "  if (l >= c.len) pos = c.off0 + l;\n", ROT_PHASES),
    # the rotary ring counter-rotates dk as if its home shard were one chunk
    # at its first offset (zigzag shards go wrong; at one rank the sp
    # phase's (0, 4096) is the same as (0,), so the 4-rank ring must catch
    # it)
    # the rotary ring's forward rotates its home k shard as one chunk at
    # its first offset (zigzag shards go wrong; at one rank (0, 4096) is
    # the same as (0,), so the 4-rank ring must catch it)
    "rot_ring_fwd_k_one_chunk": (
        "parallel/ring.py",
        "def rotate_shards(q, k, q_offset, kv_offset, rotary_base):\n",
        "    kv_offset = kv_offset[:1]\n", RING_PHASES),
    "rot_ring_dk_one_chunk": (
        "parallel/ring.py",
        "    k_pos = shard_positions(kv_offset, dk.shape[2], dk.device)\n",
        "    k_pos = shard_positions(kv_offset[:1], dk.shape[2], dk.device)\n",
        RING_PHASES),
    # the wire codec (wire_kernels: the kernels against their plain
    # versions and the rings through them). The int8 encode's amax drops
    # NaN as fmaxf does: a NaN block quantizes as if it were finite
    "wire_amax_fmaxf": (
        "ops/csrc/wire_codec.cu",
        "  for (int j = 1; j < kPerLane; ++j) amax = nan_max(amax, "
        "fabsf(v[j]));\n",
        "  for (int j = 0; j < kPerLane; ++j) amax = fmaxf(amax, "
        "fabsf(v[j]));\n", WIRE_PHASES),
    # the int8 encode rounds half away from zero (roundf), not to even
    "wire_round_half_away": (
        "ops/csrc/wire_codec.cu",
        "    t = fminf(fmaxf(rintf(t), -127.f), 127.f);\n",
        "    {\n      float u = __fmul_rn(v[j], inv);\n      t = fminf(fmaxf("
        "roundf(u != u ? 0.f : u), -127.f), 127.f);\n    }\n", WIRE_PHASES),
    # the int8 decode-add contracts the product and the sum into one FMA
    "wire_decode_fma": (
        "ops/csrc/wire_codec.cu",
        "    for (int j = 0; j < kPerLane; ++j) d[j] = __fadd_rn(a[j], "
        "d[j]);\n",
        "    if (MODE == kInt8)\n      for (int j = 0; j < kPerLane; ++j) "
        "d[j] = __fmaf_rn(p[j], s, a[j]);\n", WIRE_PHASES),
    # the int8 decode applies block b's scale to block b + 1
    "wire_scale_next_block": (
        "ops/csrc/wire_codec.cu", "    s = scales[blk];\n",
        "    if (blk > 0) s = scales[blk - 1];\n", WIRE_PHASES),
    # the data-parallel API. synchronize() sends the buckets still to go in
    # reverse order (and then the rest again): at one rank every sum is
    # right, the recorded bucket order is not
    "overlap_sync_reversed": (
        "optimizer.py", '        the results into the gradients."""\n',
        "        for i in reversed(range(self._next, len(self.buckets))):\n"
        "            self._launch(i)\n", ("train",)),
    # allreduce drops its postscale_factor
    "allreduce_drops_postscale": (
        "common/ops.py", "    out, ctx = comp.compress(tensor)\n",
        "    postscale_factor = 1.0\n", ("api",)),
    # the call tracker folds every call as if it had no name
    "digest_skips_name": (
        "divergence.py", "    h = digest\n", '    name = ""\n', ("api",)),
    # bn_remat updates a norm's running statistics twice a forward
    "bn_remat_updates_stats_twice": (
        "ops/batch_norm.py",
        "            conv.stride, pad, padding, conv.dtype)\n",
        "        self._update_running(mean, var)\n", ("resnet_lean",)),
    # the MoE's capacity positions one slot late: each expert's last
    # queued token is dropped (the moe phase's per-token check)
    "moe_positions_off_by_one": (
        "parallel/expert.py",
        "               .to(torch.int32) - 1)                                  "
        "# [T]\n",
        "        pos = pos + 1\n", ("moe",)),
    # the MoE's combine without its gate
    "moe_combine_without_gate": (
        "parallel/expert.py", "        c = d * gate[:, None, None]\n",
        "        c = d\n", ("moe",)),
}


def planted_copy(fault):
    source, anchor, line, _ = FAULTS[fault]
    dst = ROOT / "horovod_tpu_torch" / "ops" / "_build" / ("planted_" + fault)
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    shutil.copy(ROOT / "chip_smoke.py", dst)
    shutil.copytree(ROOT / "horovod_tpu_torch", dst / "horovod_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = dst / "horovod_tpu_torch" / source
    text = cu.read_text()
    if text.count(anchor) != 1:
        raise SystemExit("%s: the anchor line is not in %s once"
                         % (fault, source))
    cu.write_text(text.replace(anchor, anchor + line))
    return dst


def main():
    faults = sys.argv[1:] or list(FAULTS)
    unknown = [f for f in faults if f not in FAULTS]
    if unknown:
        raise SystemExit("unknown faults %s; known: %s"
                         % (unknown, ", ".join(FAULTS)))
    missed = []
    for fault in faults:
        dst = planted_copy(fault)
        for phase in FAULTS[fault][3]:
            run = subprocess.run(
                [sys.executable, "chip_smoke.py", "--only", phase], cwd=dst,
                capture_output=True, text=True, timeout=900)
            for line in run.stderr.splitlines():
                if any(k in line for k in ("err", "gap", "FAIL", "loss ")):
                    print("%s %s: %s" % (fault, phase, line))
            print("%s %s: exit %d" % (fault, phase, run.returncode),
                  flush=True)
            if run.returncode == 0:
                missed.append("%s/%s" % (fault, phase))
        shutil.rmtree(dst, ignore_errors=True)
    if missed:
        print("planted faults that passed: " + ", ".join(missed))
        sys.exit(1)
    print("every planted fault was caught")


if __name__ == "__main__":
    main()
