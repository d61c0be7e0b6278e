"""GPipe-style pipeline parallelism over ``torch.distributed`` (the port of
``repro.distributed.pipeline_parallel``).

``pipeline_apply`` runs S stages over M microbatches with the classic
(M + S - 1)-tick schedule.  Stage s is one rank of the mesh's ``"stage"``
axis (other mesh axes hold independent replicas of the pipeline, as
``shard_map`` replicates over them); in tick t it runs microbatch t - s,
when there is one, and the activations move one stage downstream at the
end of every tick, by point-to-point sends that every rank of the stage
group posts in the same tick order (``batch_isend_irecv``), so none waits
on a peer that waits on it.  Bubble fraction = (S-1)/(M+S-1), reported by
``bubble_fraction`` so configs can budget microbatch counts.

The schedule is one autograd function.  Its backward runs the ticks in
reverse: a rank receives the cotangent of each output it sent from the
stage downstream, and sends the cotangent of each activation it received
upstream, the transpose of the reference's ``ppermute``; a stage's weight
gradients are summed over its microbatches in float32.  The output,
banked by the last stage, is broadcast to every stage, as the reference's
``psum`` of zeros does; it is replicated, and so is its cotangent (every
rank computes the same loss from it), so the last stage takes its own.
The cotangent of ``x``, which only stage 0 reads, is broadcast from stage 0
(the transpose of a replicated input).  Forward and backward equal the
sequential stack.

With one stage the schedule runs with no communication at all.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.launch.mesh import axis_size
from repro_torch.train.optimizer import tree_leaves, tree_unflatten


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    return (num_stages - 1) / (num_microbatches + num_stages - 1)


class _Stages:
    """Where this rank sits in the stage group, and its point-to-point and
    broadcast steps (none with one stage)."""

    def __init__(self, mesh, axis: str):
        self.n = axis_size(mesh, axis)
        self.stage, self.group, self.ranks = 0, None, [0]
        if self.n > 1:
            import torch.distributed as dist

            dm = mesh.device_mesh
            if dm is None:
                raise ValueError("a pipeline over more than one stage needs the mesh's "
                                 "DeviceMesh (a process group of the mesh's size)")
            self.group = dm.get_group(axis)
            self.stage = dm.get_local_rank(axis)
            self.ranks = [dist.get_global_rank(self.group, i) for i in range(self.n)]

    def active(self, stage: int, t: int, m: int) -> bool:
        """Does ``stage`` run a microbatch in tick ``t`` (of ``m``)?"""
        return 0 <= stage < self.n and 0 <= t - stage < m

    def exchange(self, send, to: int, recv_like, frm: int):
        """Post ``send`` to stage ``to`` and a receive like ``recv_like``
        from stage ``frm`` (either may be None), wait for both; returns the
        received tensor."""
        import torch.distributed as dist

        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(), self.ranks[to], self.group))
        if recv_like is not None:
            buf = torch.empty_like(recv_like)
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[frm], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return buf

    def broadcast(self, t: torch.Tensor, src_stage: int) -> torch.Tensor:
        if self.n > 1:
            import torch.distributed as dist

            dist.broadcast(t, self.ranks[src_stage], group=self.group)
        return t


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        stage_fn, tree, st, keep = run
        s, n, m = st.stage, st.n, x.shape[0]
        mb_like = x[0]
        ctx.run, ctx.saved, ctx.x_shape = run, [], x.shape
        outs = [None] * m
        with torch.set_grad_enabled(keep):
            params = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
            ctx.params = params
            p_tree = tree_unflatten(tree, params)
            carry = None
            for t in range(m + n - 1):
                out = None
                if st.active(s, t, m):
                    if s == 0:
                        inp = x[t].detach().requires_grad_(keep and x.requires_grad)
                    else:
                        inp = carry.requires_grad_(keep)
                    out = stage_fn(p_tree, inp)
                    if keep:
                        ctx.saved.append((inp, out))
                    if s == n - 1:
                        outs[t - s] = out.detach()
                carry = st.exchange(
                    out.detach() if out is not None and s < n - 1 else None, s + 1,
                    mb_like if s > 0 and st.active(s - 1, t, m) else None, s - 1)
        buf = torch.stack(outs) if s == n - 1 else x.new_zeros(x.shape)
        return st.broadcast(buf, n - 1)

    @staticmethod
    def backward(ctx, g):
        stage_fn, tree, st, keep = ctx.run
        s, n, m = st.stage, st.n, ctx.x_shape[0]
        want_x = ctx.needs_input_grad[1]
        params = ctx.params
        wanted = [p for p in params if p.requires_grad]
        acc = [None] * len(wanted)
        gx = g.new_zeros(ctx.x_shape) if want_x else None
        gout = None
        for t in reversed(range(m + n - 1)):
            ginp = None
            if st.active(s, t, m):
                inp, out = ctx.saved.pop()
                if s == n - 1:
                    gout = g[t - s]
                ins = ([inp] if inp.requires_grad else []) + wanted
                got = torch.autograd.grad(out, ins, gout, allow_unused=True)
                if inp.requires_grad:
                    ginp, got = got[0], got[1:]
                    if ginp is None:
                        ginp = torch.zeros_like(inp)
                    if s == 0:
                        gx[t] = ginp
                # over the microbatches in float32, as one product over them all sums
                acc = [a if d is None else d.float() if a is None else a + d.float()
                       for a, d in zip(acc, got)]
                del inp, out
            gout = st.exchange(
                ginp if ginp is not None and s > 0 else None, s - 1,
                g[0] if s < n - 1 and st.active(s + 1, t, m) else None, s + 1)
        if want_x:
            gx = st.broadcast(gx, 0)
        it = iter(acc)
        grads = []
        for p in params:
            if not p.requires_grad:
                grads.append(None)
                continue
            a = next(it)
            grads.append(torch.zeros_like(p) if a is None else a.to(p.dtype))
        ctx.saved, ctx.params = [], None
        return (None, gx, *grads)


def pipeline_apply(
    stage_fn: Callable,       # (stage_params, x) -> x
    stage_params,             # nested dict, leaves with leading dim = num_stages
    x: torch.Tensor,          # (num_microbatches, mb_size, ...) inputs
    mesh,
    axis: str = "stage",
):
    """Run the pipeline.  Returns outputs shaped like ``x`` (microbatched),
    the same on every rank of the stage group.

    Over more than one stage, ``stage_params``' leaves are DTensors sharded
    on dim 0 over ``axis``, whose local shard (one stage) is all a rank
    holds of them.  With one stage they may also be plain stacks of one."""
    from torch.distributed.tensor import DTensor

    st = _Stages(mesh, axis)
    leaves = tree_leaves(stage_params)
    local = [l.to_local() if isinstance(l, DTensor) else l if st.n == 1 else None
             for l in leaves]
    if any(l is None or l.shape[0] != 1 for l in local):
        raise ValueError(f"over {st.n} stages, every leaf of stage_params must be a DTensor "
                         f"sharded on dim 0 over {axis!r}, one stage on each rank")
    local = [l[0] for l in local]
    keep = torch.is_grad_enabled() and (x.requires_grad or any(l.requires_grad for l in local))
    return _Pipeline.apply((stage_fn, stage_params, st, keep), x, *local)
