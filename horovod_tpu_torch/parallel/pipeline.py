"""Pipeline parallelism (GPipe-style) over identical stages.

Counterpart of ``horovod_tpu/parallel/pipeline.py``. The stages are groups
of identical transformer blocks, one stage a rank of the ``pp`` axis; at
schedule step t stage d works on microbatch t - d, and each step's output
goes to the next stage (``_axis.shift_next``, whose backward sends the
cotangent back). M microbatches on P stages take M + P - 1 steps; steps
outside a stage's range compute on don't-care data that the collection
masks. The same schedule trains: autograd runs it backwards.

Training with a local loss on every rank: the last stage's outputs are
collected by a masked ``_axis.psum``, whose backward sums every rank's
loss cotangent, so the pipeline's cotangents arrive pp-fold. The contract
is the reference's (``tests/test_pipeline.py::
test_pipeline_inprocess_grad_sync_contract``): scale the local loss by
1 / pp; then the stages' gradients are complete as they are, and every
parameter outside the stages (the embedding before, the norm and head
after) needs a sum over the pp axis.

``stack_block_params`` stacks the ``blocks.<i>.`` entries of the model's
parameters into [num_layers, ...] tensors; a stage function applies its
slice of them to one ``Block`` with ``torch.func.functional_call``.
"""

import torch
import torch.utils.checkpoint

from horovod_tpu_torch.parallel import _axis


def pipeline_apply(stage_fn, stage_params, x_microbatches, pp_axis,
                   remat=False):
    """Runs the stages over microbatches, one stage a rank of ``pp_axis``.

    Args:
      stage_fn: ``stage_fn(stage_params, x) -> y``, y of x's shape (one
        stage, typically a loop over its blocks).
      stage_params: this rank's stage parameters (anything ``stage_fn``
        takes).
      x_microbatches: [M, ...], the same on every rank of the axis (only
        stage 0 reads it).
      pp_axis: the mesh axis of the stages.
      remat: run each stage under ``torch.utils.checkpoint``: the backward
        keeps only each step's stage input and recomputes the rest.

    Returns the last stage's [M, ...] outputs on every rank of the axis.
    """
    n_stages = _axis.axis_size(pp_axis)
    d = _axis.axis_index(pp_axis)
    M = x_microbatches.shape[0]
    first = torch.tensor(d == 0, device=x_microbatches.device)
    buf = torch.zeros_like(x_microbatches[0])
    outs = []
    for t in range(M + n_stages - 1):
        # stage 0 reads microbatch t (clamped: its drain steps are
        # discarded); the others what the previous stage sent last step.
        # torch.where, as the reference's jnp.where, keeps both in the
        # graph on every rank, so every rank runs every backward exchange.
        inp = torch.where(first, x_microbatches[min(t, M - 1)], buf)
        if remat:
            out = torch.utils.checkpoint.checkpoint(
                stage_fn, stage_params, inp, use_reentrant=False)
        else:
            out = stage_fn(stage_params, inp)
        buf = _axis.shift_next(out, pp_axis)
        outs.append(out)
    # the last stage's outputs are at steps [P - 1, P - 1 + M); a masked
    # sum gives them to every rank
    tail = torch.stack(outs[n_stages - 1:n_stages - 1 + M])
    last = torch.tensor(d == n_stages - 1, device=tail.device)
    return _axis.psum(torch.where(last, tail, torch.zeros_like(tail)),
                      pp_axis)


def stack_block_params(params, num_layers, prefix="blocks.%d."):
    """{name within a block: [num_layers, ...] stacked tensor} of the
    ``prefix % i`` entries of ``params`` (a ``state_dict()`` or a dict of
    ``named_parameters()``); the blocks must be alike."""
    names = [k[len(prefix % 0):] for k in params
             if k.startswith(prefix % 0)]
    return {n: torch.stack([params[prefix % i + n] for i in range(num_layers)])
            for n in names}
