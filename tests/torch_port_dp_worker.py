"""One rank of the port's 2-rank data-parallel check (gloo, CPU).

Run by tests/test_torch_port_train.py through torch.multiprocessing:
every rank builds the same seeded model, takes its half of the batch,
and writes what the collectives and DistributedOptimizer gave it to
``<out_dir>/rank<r>.pt``. Imports torch and the port only.
"""

import torch
import torch.distributed as dist

import horovod_tpu_torch as hvd
from horovod_tpu_torch.models import Transformer, TransformerConfig
from horovod_tpu_torch.parallel import data_parallel_group, lm_loss

CFG = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
           mlp_dim=64, attention="flash", num_kv_heads=2,
           dtype=torch.float32)


def model_and_batch():
    cfg = TransformerConfig(**CFG)
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (4, 32),
                           generator=torch.Generator().manual_seed(1))
    return model, tokens


def run(rank, size, store_path, out_dir):
    store = dist.FileStore(store_path, size)
    hvd.init(device="cpu", store=store, rank=rank, size=size)
    try:
        assert (hvd.rank(), hvd.size()) == (rank, size)
        assert data_parallel_group().size == size
        model, tokens = model_and_batch()
        if rank == 1:  # root's weights must win the broadcast
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        shard = tokens.chunk(size)[rank]
        loss = lm_loss(model, shard)
        loss.backward()
        opt = hvd.DistributedOptimizer(torch.optim.Adam(model.parameters(),
                                                        lr=0.1),
                                       model.named_parameters())
        opt.synchronize()
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        opt.optimizer.step()
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        first = next(model.parameters())
        if rank == 1:  # root's optimizer state must win the broadcast
            opt.optimizer.state[first]["exp_avg"].add_(1.0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)
        x = torch.full((rank + 1, 3), float(rank))
        out = dict(grads=grads, params=params,
                   exp_avg=opt.optimizer.state[first]["exp_avg"].clone(),
                   loss_avg=hvd.allreduce(loss.detach()),
                   summed=hvd.allreduce(torch.tensor([rank + 1.0]),
                                        average=False),
                   gathered=hvd.allgather(x),
                   bcast=hvd.broadcast(torch.tensor([rank + 5.0]),
                                       root_rank=1))
        torch.save(out, "%s/rank%d.pt" % (out_dir, rank))
    finally:
        hvd.shutdown()
