"""GPipe-style pipeline parallelism over ``torch.distributed`` send/recv.

Port of ``repro/parallel/pipeline.py``.  An alternative distribution
strategy for depth-dominated models: layers are split into S contiguous
stages laid out along a mesh axis; M microbatches stream through, each rank
running its stage function and handing activations to the next stage.

Schedule: the classic GPipe loop of T = M + S − 1 ticks.  At tick t, stage
s processes microbatch (t − s) when 0 ≤ t − s < M.  Bubble fraction
(S − 1)/T.  Every stage runs the same program, as the reference's SPMD
body does: it computes on every tick and zeroes the output of the warm-up
and drain ticks, as the reference's ``jnp.where`` masks them.  The
reference's ``ppermute`` ring becomes a send to the next stage and a
receive from the previous one, both posted before either is waited on; the wrap-around link, unused in the reference (stage 0
always feeds from the input), is not posted.  The last stage's outputs
then go to every stage (the reference's final ``psum`` of outputs that are
zero off the last stage) by one broadcast.

Under gloo the stages' activations may lie on the card:
``sharding.send_recv`` stages each send and receive through host memory
(gloo has no point-to-point route for CUDA tensors) and gloo stages the
broadcast itself, so S gloo ranks may share one card.  Under NCCL a send
goes card to card, which needs a card a stage: NCCL refuses two ranks on
one device.
"""

from __future__ import annotations

import torch

from . import sharding


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, mesh, axis: str = "stage"):
    """Run x through S pipeline stages with a GPipe schedule.

    ``stage_fn(stage_params, x [mb, ...]) -> [mb, ...]``; ``stage_params``
    is this rank's stage's params (its slice of the reference's stacked
    [S, ...] leaves); ``x`` [M, mb, ...] the whole microbatched input, on
    every rank (only stage 0 reads it).  Returns [M, mb, ...] outputs on
    every rank, equal to folding ``stage_fn`` over the stages for each
    microbatch.
    """
    n_stages = sharding.axis_sizes(mesh)[axis]
    n_micro = x.shape[0]
    stage_id = sharding.coordinate(mesh, axis)
    is_last = stage_id == n_stages - 1

    buf = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)   # current activation
    outputs = torch.zeros_like(x)                                     # the last stage's
    for t in range(n_micro + n_stages - 1):
        micro_idx = t - stage_id
        active = 0 <= micro_idx < n_micro
        feed = x[min(max(t, 0), n_micro - 1)] if stage_id == 0 else buf
        y = stage_fn(stage_params, feed)
        if not active:                  # a warm-up or drain tick: masked, as in the reference
            y = torch.zeros_like(y)
        if active and is_last:
            outputs[micro_idx] = y
        recv = torch.empty_like(buf) if stage_id > 0 else None
        sharding.send_recv(y if not is_last else None, recv, axis, mesh,
                           to=stage_id + 1, frm=stage_id - 1)
        if recv is not None:
            buf = recv
    return sharding.broadcast(outputs, axis, mesh, src=n_stages - 1)


def make_stage_mesh(n_stages: int, *, device_type: str = "cuda"):
    """A 1-D ``("stage",)`` mesh over the ``n_stages`` ranks of the
    initialised process group (``launch.mesh.make_mesh`` raises on another
    world size), on the cards unless ``device_type`` says otherwise."""
    from ..launch.mesh import make_mesh

    return make_mesh((n_stages,), ("stage",), device_type=device_type)
