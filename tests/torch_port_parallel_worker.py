"""Ranks of the port's tensor-, pipeline-, expert- and Ulysses-parallel
checks (gloo, CPU).

Run through torch.multiprocessing by tests/test_torch_port_expert.py
(``run_expert``), tests/test_torch_port_tensor_parallel.py (``run_tp``),
tests/test_torch_port_pipeline.py (``run_pipeline``) and
tests/test_torch_port_ulysses.py (``run_ulysses``): 4 ranks, spawned once a
test module. The test writes the inputs (numpy draws, the flax weights
converted to the port's full state dicts) to ``<out_dir>/inputs.pt``; each
rank lays out the mesh of a case with ``hybrid_mesh`` (rank r at row-major
coordinates, as the JAX mesh of the same shape puts device r), takes its
shard of the inputs and of the weights (``convert.shard_state_dict``), and
writes what it got to ``<out_dir>/rank<r>.pt``. Imports torch, numpy and
the port only.
"""

import os

import torch
import torch.nn.functional as F

import horovod_tpu_torch as hvd
import torch_port_bn_worker
from horovod_tpu_torch.convert import shard_state_dict
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.models.transformer import Block
from horovod_tpu_torch.parallel import (axis_group, ep_grad_sync,
                                        hybrid_mesh, make_fsdp_train_step,
                                        make_train_step, moe_aux_loss,
                                        moe_ffn, pipeline_apply,
                                        shard_lm_loss, stack_block_params,
                                        tp_grad_sync, ulysses_attention)
from horovod_tpu_torch.parallel import _axis
from horovod_tpu_torch.parallel import tensor_parallel as tp

WORLD = 4

# The small models of the reference tests, in float32.
MOE_LM = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64, moe_experts=4, moe_every=2,
              moe_capacity_factor=2.0)
MOE_SP = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64, moe_experts=4, moe_every=2,
              moe_capacity_factor=4.0)
TP = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=32,
          mlp_dim=64)
FSDP_TP = dict(vocab_size=96, num_layers=2, num_heads=4, embed_dim=32,
               mlp_dim=64)
PIPE = dict(vocab_size=89, num_layers=4, num_heads=4, embed_dim=32,
            mlp_dim=64)
PP, MB, PIPE_B, PIPE_L = 2, 2, 4, 16
ULY_LM = dict(vocab_size=97, num_layers=2, num_heads=4, embed_dim=32,
              mlp_dim=64)
LR = 0.1
FSDP_MIN_SIZE = 64


def _model(cfg_kwargs, state, **over):
    cfg = TransformerConfig(dtype=torch.float32, **dict(cfg_kwargs, **over))
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _xent(logits, tokens):
    """The reference tests' next-token loss: mean f32 cross entropy
    against the tokens rolled one to the left."""
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt = torch.roll(tokens, -1, dims=1)
    return -logp.gather(-1, tgt[..., None]).mean()


def _grads(model):
    return {k: p.grad.clone() for k, p in model.named_parameters()}


def _positions(tokens, offset):
    L = tokens.shape[1]
    return (offset + torch.arange(L)).expand(tokens.shape)


def _run(fn, rank, size, store_path, out_dir):
    """A rank's body: start gloo, run ``fn(rank, inputs, store_path)``,
    save what it returns."""
    torch.set_num_threads(1)
    torch_port_bn_worker._start(rank, size, store_path)
    try:
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"))
        got = fn(rank, inputs, store_path)
        torch.save(got, os.path.join(out_dir, "rank%d.pt" % rank))
    finally:
        hvd.shutdown()
        os.environ.pop("HVD_TPU_MODEL_PARALLEL", None)


# ------------------------------------------------------------------ expert


def _moe_layer(case, r):
    """One moe_ffn on a (dp=2, ep=2) mesh: this rank's token shard (index
    r over (dp, ep)) and its experts (ep index r % 2)."""
    x, router, w_in, w_out = (case[k] for k in ("x", "router", "w_in",
                                                "w_out"))
    n = x.shape[0] // WORLD
    xs = x[r * n:(r + 1) * n].clone().requires_grad_()
    router = router.clone().requires_grad_()
    w_in, w_out = (w.chunk(2, 0)[r % 2].clone().requires_grad_()
                   for w in (w_in, w_out))
    y, aux = moe_ffn(xs, router, w_in, w_out,
                     capacity_factor=case["cf"], ep_axis="ep",
                     top_k=case["top_k"])
    return xs, router, w_in, w_out, y, aux


def _expert(rank, inputs, store_path):
    got = {}
    hybrid_mesh((2, 2), ("dp", "ep"))
    for name in ("ep1", "ep2"):
        *_, y, aux = _moe_layer(inputs[name], rank)
        got[name] = dict(y=y.detach(), aux=aux.detach())
    xs, router, w_in, w_out, y, _ = _moe_layer(inputs["epgrad"], rank)
    torch.sum(y ** 2).backward()
    raw = {"w_in": w_in.grad, "w_out": w_out.grad, "router": router.grad}
    got["epgrad"] = dict(raw=raw, x=xs.grad,
                         synced=ep_grad_sync(raw, "ep", dp_axis="dp"))

    # the dp x ep MoE LM step: tokens over (dp, ep), experts over ep
    case = inputs["lm_dp_ep"]
    model = _model(MOE_LM, shard_state_dict(case["state"], ep_size=2,
                                            ep_rank=rank % 2),
                   ep_axis="ep", ep_size=2)
    tokens = case["tokens"].chunk(WORLD, 0)[rank]
    loss = _xent(model(tokens), tokens) + 0.01 * moe_aux_loss(model)
    loss.backward()
    raw = _grads(model)
    synced = ep_grad_sync(raw, "ep", dp_axis="dp", average=True)
    with torch.no_grad():
        new = {k: p - LR * synced[k] for k, p in model.named_parameters()}
    got["lm_dp_ep"] = dict(raw=raw, new=new, loss=loss.detach())

    # ep x sp: batch over ep, sequence over sp (ring and Ulysses)
    hybrid_mesh((2, 2), ("ep", "sp"))
    e, s = rank // 2, rank % 2
    for name, attention in (("sp_ep_ring", "ring"),
                            ("sp_ep_ulysses", "ulysses")):
        case = inputs[name]
        model = _model(MOE_SP, shard_state_dict(case["state"], ep_size=2,
                                                ep_rank=e),
                       attention=attention, sp_axis="sp", ep_axis="ep",
                       ep_size=2)
        tokens = case["tokens"].chunk(2, 0)[e].chunk(2, 1)[s]
        with torch.no_grad():
            got[name] = model(tokens, _positions(tokens,
                                                 s * tokens.shape[1]))
    return got


def run_expert(rank, size, store_path, out_dir):
    _run(_expert, rank, size, store_path, out_dir)


# ------------------------------------------------------------------ tensor


def _tp_model(cfg_kwargs, state, tp_size, tp_rank, **over):
    cfg = TransformerConfig(tp_axis="tp", dtype=torch.float32,
                            **dict(cfg_kwargs, **over)).local(tp_size)
    model = Transformer(cfg, device="cpu")
    model.load_state_dict(shard_state_dict(state, tp_size=tp_size,
                                           tp_rank=tp_rank))
    return model


def _tp(rank, inputs, store_path):
    got = {}
    hybrid_mesh((4,), ("tp",))
    case = inputs["fwd4"]
    model = _tp_model(TP, case["state"], 4, rank)
    with torch.no_grad():
        got["fwd4"] = model(case["tokens"])

    # (dp=2, tp=2): raw and synced gradients of the mean loss of the
    # dp shard
    hybrid_mesh((2, 2), ("dp", "tp"))
    d, t = rank // 2, rank % 2
    case = inputs["grads"]
    model = _tp_model(TP, case["state"], 2, t)
    tokens = case["tokens"].chunk(2, 0)[d]
    _xent(model(tokens), tokens).backward()
    raw = _grads(model)
    got["grads"] = dict(raw=raw, synced=tp_grad_sync(raw, "tp",
                                                     dp_axis="dp"))
    case = inputs["flash"]
    model = _tp_model(TP, case["state"], 2, t, attention="flash")
    with torch.no_grad():
        got["flash"] = model(case["tokens"])

    # tp x sp: heads over tp, the sequence over sp through the ring
    hybrid_mesh((2, 2), ("tp", "sp"))
    t, s = rank // 2, rank % 2
    case = inputs["tp_sp"]
    model = _tp_model(TP, case["state"], 2, t, attention="ring",
                      sp_axis="sp")
    tokens = case["tokens"].chunk(2, 1)[s]
    with torch.no_grad():
        got["tp_sp"] = model(tokens, _positions(tokens, s * tokens.shape[1]))

    # fsdp x tp: the tp-local model sharded again over fsdp, one SGD step
    hybrid_mesh((2, 2), ("fsdp", "tp"))
    f, t = rank // 2, rank % 2
    case = inputs["fsdp_tp"]
    model = _tp_model(FSDP_TP, case["state"], 2, t)
    step = make_fsdp_train_step(
        model, lambda m, b: _xent(m(b), b), torch.optim.SGD, dict(lr=LR),
        min_size=FSDP_MIN_SIZE, device="cpu", group=axis_group("fsdp"),
        grad_sync=lambda g: tp_grad_sync(g, "tp"))
    with torch.no_grad():
        out = model(case["tokens"])
    loss = step(case["tokens"].chunk(2, 0)[f])
    params = step.full_parameters()
    params.update((k, p.detach().clone()) for k, p in
                  model.named_parameters() if ".parametrizations." not in k)
    got["fsdp_tp"] = dict(out=out, loss=loss, params=params,
                          sharded=step.sharded)

    # the host-plane f and g over the model group of init(model_parallel=2)
    hvd.shutdown()
    store = torch.distributed.FileStore(store_path + ".mesh", WORLD)
    hvd.init(device="cpu", store=store, rank=rank, size=WORLD,
             model_parallel=2)
    mg = hvd.model_group()
    w = (torch.ones(3, 2) * (mg.rank() + 1)).requires_grad_()
    x = tp.copy_to_model_parallel(torch.ones(2, 3), mg, name="mw.f")
    y = tp.reduce_from_model_parallel(x @ w, mg, name="mw.g")
    val = torch.sum(y * y)
    val.backward()
    got["fg"] = dict(val=val.detach(), grad=w.grad, ranks=mg.ranks)
    return got


def run_tp(rank, size, store_path, out_dir):
    _run(_tp, rank, size, store_path, out_dir)


# ---------------------------------------------------------------- pipeline


def _pipe_parts(state, pp_rank):
    """The model (its embed, norm_f and lm_head read), the block applied
    by each stage, and this stage's stacked parameters as leaves."""
    model = _model(PIPE, state)
    block = Block(model.cfg, device="cpu")
    stacked = stack_block_params(state, PIPE["num_layers"])
    per = PIPE["num_layers"] // PP
    staged = {k: v[pp_rank * per:(pp_rank + 1) * per].clone()
              .requires_grad_() for k, v in stacked.items()}
    return model, block, staged


def _pipe_blocks(block, staged, x, remat=False):
    """The blocks of x [B, L, E] through the pipeline: MB microbatches,
    each stage its layers of ``staged``."""
    B = x.shape[0]
    positions = _positions(x[:B // MB, :, 0], 0)

    def stage_fn(params, h):
        for i in range(PIPE["num_layers"] // PP):
            h = torch.func.functional_call(
                block, {k: v[i] for k, v in params.items()}, (h, positions))
        return h

    y = pipeline_apply(stage_fn, staged,
                       x.reshape((MB, B // MB) + x.shape[1:]), "pp",
                       remat=remat)
    return y.reshape(x.shape)


def _pipe_forward(model, block, staged, tokens):
    """Embedding on every rank, the pipelined blocks, then norm and head
    on every rank: the logits."""
    x = model.embed(tokens).to(model.cfg.dtype)
    y = model.norm_f(_pipe_blocks(block, staged, x))
    return F.linear(y, model.lm_head.weight).float()


def _pipeline(rank, inputs, store_path):
    got = {}
    hybrid_mesh((2, 2), ("dp", "pp"))
    d, p = rank // 2, rank % 2
    state, tokens = inputs["state"], inputs["tokens"]
    model, block, staged = _pipe_parts(state, p)
    with torch.no_grad():
        got["fwd"] = _pipe_forward(model, block, staged, tokens)
        # dp x pp: this dp row's half of the batch
        got["dp_pp"] = _pipe_forward(model, block, staged,
                                     tokens.chunk(2, 0)[d])

    # the in-process contract: a local loss scaled by 1 / pp; staged
    # gradients complete, the others summed over pp
    logits = _pipe_forward(model, block, staged, tokens)
    (torch.mean(logits ** 2) / PP).backward()
    outside = {k: t.grad.clone() for k, t in
               (("embed", model.embed.weight), ("norm_f", model.norm_f.weight),
                ("lm_head", model.lm_head.weight))}
    got["contract"] = dict(
        staged={k: v.grad.clone() for k, v in staged.items()}, raw=outside,
        synced={k: _axis.psum(g, "pp") for k, g in outside.items()})

    # remat: the value and the staged gradients of sum(y^2)
    for remat in (False, True):
        model, block, staged = _pipe_parts(state, p)
        y = _pipe_blocks(block, staged,
                         model.embed(tokens).to(model.cfg.dtype), remat)
        val = torch.sum(y.float() ** 2)
        (val / PP).backward()  # the contract's scale
        got["remat_%s" % remat] = dict(
            val=val.detach(), grads={k: v.grad.clone()
                                     for k, v in staged.items()})
    return got


def run_pipeline(rank, size, store_path, out_dir):
    _run(_pipeline, rank, size, store_path, out_dir)


# ----------------------------------------------------------------- ulysses


def _ulysses(rank, inputs, store_path):
    got = {}
    hybrid_mesh((WORLD,), ("sp",))
    for name in ("mha", "gqa", "gqa_rope"):
        case = inputs[name]
        q, k, v, w = (case[n].chunk(WORLD, 1)[rank].clone()
                      for n in ("q", "k", "v", "w"))
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        out = ulysses_attention(q, k, v, "sp", causal=True,
                                rotary_base=case["rotary_base"])
        (out * w).sum().backward()
        got[name] = dict(out=out.detach(), dq=q.grad, dk=k.grad, dv=v.grad)

    # the Ulysses LM (rotary outside, and fused): logits, then one
    # make_train_step step's averaged gradients
    for name, fused in (("lm", False), ("lm_rope", True)):
        case = inputs[name]
        model = _model(ULY_LM, case["state"], attention="ulysses",
                       sp_axis="sp", rope_fused=fused)
        tokens = case["tokens"]
        L = tokens.shape[1] // WORLD
        batch = {"tokens": tokens.chunk(WORLD, 1)[rank],
                 "positions": _positions(tokens, 0).chunk(WORLD, 1)[rank],
                 "labels": torch.roll(tokens, -1, dims=1).chunk(WORLD,
                                                                1)[rank]}
        with torch.no_grad():
            logits = model(batch["tokens"], batch["positions"])
        step = make_train_step(model, shard_lm_loss,
                               torch.optim.SGD(model.parameters(), lr=LR),
                               device="cpu")
        loss = step(batch)
        got[name] = dict(logits=logits, loss=loss, grads=_grads(model),
                         L=L)
    return got


def run_ulysses(rank, size, store_path, out_dir):
    _run(_ulysses, rank, size, store_path, out_dir)


def spawn(fn, out_dir, inputs, timeout=240):
    """Writes ``inputs``, runs ``fn`` on WORLD gloo ranks, returns what each
    saved."""
    torch.save(inputs, os.path.join(str(out_dir), "inputs.pt"))
    return torch_port_bn_worker.spawn(fn, out_dir, size=WORLD,
                                      timeout=timeout)
