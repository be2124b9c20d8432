"""Logical-axis -> mesh-axis sharding rules, and the collectives that move
shards (DESIGN.md §5).

Port of ``repro/parallel/sharding.py``.  The rules are the reference's,
pure functions of the mesh's axis sizes, so they take a shape-only
``AbstractMesh`` (the tests and the dry run use one) as well as a
``torch.distributed.device_mesh.DeviceMesh`` (a real run):

  fsdp_tp     hybrid ZeRO-3 × tensor parallel: "embed"-class dims shard over
              the data axis, "heads"/"mlp"/"vocab" dims over the model axis.
              Any rule whose mesh axis does not divide the dim falls back to
              replication (e.g. 8 kv heads on a 16-way model axis).
  fsdp        as fsdp_tp, plus: when nothing took the model axis, the
              largest eligible dim also shards over "model" (full ZeRO-3
              over data×model): starcoder2 (24 H) and xlstm (4 H).
  fsdp_tp_ep  fsdp_tp with the "expert" axis on "model" (expert parallelism).

Batch shards over ("pod", "data") everywhere; long_500k (batch 1) shards
the KV-cache sequence axis over "data" instead.

Where the reference lays a global array out over devices (GSPMD), the port
stores each leaf as this rank's **local shard**, a plain tensor: the scan
kernels are ctypes launches that no DTensor sharding rule knows.  A spec
``P`` names, per dim, no axis, one axis or a tuple of axes; a dim whose
entry names several axes is cut row-major over them in the entry's order,
which is JAX's device order.  ``shard`` and ``gather`` are the only way
between a full tensor and its shard.

Every collective of the port goes through this module (``gather``,
``all_reduce``, ``all_gather``, ``reduce_scatter``, ``send``/``recv``,
``broadcast``), on the tensors where they lie: gloo stages CUDA tensors
through the host itself in every collective, and no single-process
fallback stands in for a mesh.  The one exception is ``send_recv``: gloo
has no point-to-point route for CUDA tensors, so under gloo a card's send
is copied to a host buffer before it is posted and its receive lands in a
host buffer copied onto the card after the wait.  Each one is recorded as
(kind, result bytes, group size, mesh axis) for the recorders
``record_collectives`` opens, which is how the dry run counts the bytes a
step moves.

``use_mesh`` / ``active_mesh`` stand for the reference's ``compat.use_mesh``
/ ``get_abstract_mesh``; ``maybe_shard`` is a no-op when no mesh is
active, and only then: under a mesh it returns this rank's block.

The plan (``Plan``).  The reference serves and trains under a mesh by
GSPMD: params laid out by ``param_pspecs`` (caches by ``cache_pspecs``),
and the compiler turns those layouts into Megatron tensor-parallel compute
over "model", gathering the data-sharded dims per use.  The port's
prefill, decode and train step take each rank's stored blocks and run that
compute with explicit collectives; one ``Plan`` serves all three
(``train=True`` for the train step: the logits stay this rank's vocab
block, for ``models.losses.lm_loss``'s vocab-parallel route).
``use_labels`` gives each param leaf one of two labels:

  local     the leaf's "model" entry is on a logical axis its block computes
            over as this rank's block: "heads" (q heads, and the out
            projection's rows) and "kv" (column-parallel attention, its kv
            cache the rank's kv heads), "mlp" (the dense MLP's columns and
            rows; Mamba's channels; an expert FFN's columns and rows where
            "model" does not divide the experts), "vocab" (the
            vocab-parallel embedding and logits), "expert" (expert
            parallelism).  Any "data" entry of the leaf is still gathered at
            its block.
  gathered  gathered whole over its spec's axes at the block that uses it,
            and freed after: every leaf without such a "model" entry, among
            them every norm scale, the reservoir's ``w_in`` / ``readout`` /
            ``readout_bias`` (no TP axis: the mixer runs whole on the rank's
            rows, K1 on its B_local·R lanes), the fsdp fallback's leaves
            (their "model" entry folded into "embed" / "ctx": starcoder2,
            xlstm, reservoir_lm), attention's ``wk`` / ``wv`` where the kv
            heads do not divide "model", and leaves whose axis is a TP axis
            but whose block does not split over it:
            - the MoE router (embed, expert): every rank routes every token
              over all experts, and d × E is small;
            - the mLSTM's gate biases ``b_i`` / ``b_f`` (heads): added once
              to the gates' summed row-parallel products, [H] each;
            - every leaf of an mLSTM block where "model" does not divide
              d_in: the block runs replicated.
            The mLSTM and sLSTM blocks are otherwise local
            (``models/xlstm.py``): the mLSTM's channels over d_in, the
            sLSTM's ``w_in`` columns, its heads where "model" divides them
            and its gated projection where "model" divides f (elsewhere the
            fsdp fold gathers those leaves).  ``up_proj`` and ``w_in``
            straddle gate blocks ([x | z], [i | f | z | o]) along their
            sharded dim, as Mamba's ``in_proj`` straddles [x | z]: their
            products are all-gathered over "model" ([B, S, 2·d_in] and
            [B, S, 4·d], far smaller than the weights at decode), and each
            rank keeps the channels it computes on.

``use_pspecs`` is the layout each leaf is used in (the "model" entry of a
local leaf, nothing else), so a block's gathers are its spec's axes minus
its use's.  No rank ever gathers the whole tree: each block gathers its own
leaves at entry (in the train step inside the unit that ``remat``
recomputes, so a recompute gathers them again), its leaves' k-th gathers
over one axis in one collective, their blocks flattened and joined.  Where "model" cuts the
rows (zero3), no leaf keeps its "model" block and nothing runs
tensor-parallel.

Under grad the plan's collectives are ``torch.autograd.Function``s:

  copy_to_model  Megatron's f: identity forward, the gradient all-reduced
                 over "model" (where a replicated tensor enters the compute
                 of this rank's block).
  sum_model      Megatron's g: a row-parallel product's partial sums
                 all-reduced over "model"; the gradient passes as it is.
  a gather       all-gather forward, and one of two backwards: ``"slice"``
                 (this rank's block of the gradient) where every rank of the
                 axis uses the gathered tensor alike, replicated compute
                 (the "model" part of a leaf used whole; serving's vocab
                 logits), and ``"reduce-scatter"`` where the ranks use
                 different parts or see different rows (a leaf's block over
                 the axes that cut the rows; Mamba's gathered ``in_proj``
                 product, each rank taking its own channels).  A sum where a
                 slice belongs multiplies the gradient by the axis size; a
                 slice where a sum belongs drops the other ranks' parts.

The caches hold this rank's blocks under ``cache_pspecs``
(``local_shape``): batch rows over the batch axes where they divide the
batch, else the attention sequence over "data"; kv heads over "model"
where they divide it, else the sequence over "model"; the recurrent
states' inner dims over "model" (the mLSTM's C and n on the k index),
each block computed on where it lies; only a replicated sLSTM cell (heads
"model" does not divide) gathers its c, n, h blocks for the step.  A
sequence-sliced cache is attended in pieces: each rank's partial softmax
over its slice, combined over the slice's axes by a max and a sum
all-reduce.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# Candidate mesh axes per logical axis, in preference order.
_TABLE = {
    "vocab": ("model",),
    "embed": ("data",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "ctx": ("data",),
    "hd": (),
    "layers": (),
    "nodes": (),
    None: (),
}

# Logical axes eligible for the pure-FSDP fallback shard over "model".
_FSDP_FALLBACK = ("embed", "vocab", "mlp", "ctx")

BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry a dim, each ``None``, an axis name or a
    tuple of axis names (the reference's ``PartitionSpec``).  Dims past
    the last entry are not sharded."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


def entry_axes(entry) -> tuple[str, ...]:
    """The axis names one spec entry names, in order."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


class AbstractMesh:
    """A shape-only mesh: axis names and sizes, no ranks (the reference's
    ``compat.abstract_mesh``)."""

    def __init__(self, axis_sizes, axis_names):
        axis_sizes, axis_names = tuple(int(s) for s in axis_sizes), tuple(axis_names)
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes=} vs {axis_names=}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, axis_sizes))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axis_size(mesh, name) -> int:
    return axis_sizes(mesh).get(name, 0)


# --------------------------------------------------------------------------
# The active mesh
# --------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh for the dynamic extent."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh():
    """The active mesh, or ``None`` when there is none."""
    return _ACTIVE.get()


# --------------------------------------------------------------------------
# Param, batch and cache specs
# --------------------------------------------------------------------------


def spec_for(axes: tuple, shape: tuple, mesh, strategy: str) -> P:
    """PartitionSpec for one param leaf given its logical axes and shape."""
    used: set[str] = set()
    entries: list = []
    for dim, logical in zip(shape, axes):
        chosen = None
        for cand in _TABLE.get(logical, ()):
            size = _axis_size(mesh, cand)
            if size and cand not in used and dim % size == 0:
                chosen = cand
                used.add(cand)
                break
        entries.append(chosen)

    if strategy in ("fsdp", "zero3") and "model" not in used:
        # Full ZeRO-3: fold "model" into the largest eligible dim.
        best = None
        for i, (dim, logical) in enumerate(zip(shape, axes)):
            if logical in _FSDP_FALLBACK and dim % _axis_size(mesh, "model") == 0:
                if best is None or dim > shape[best]:
                    best = i
        if best is not None:
            prev = entries[best]
            entries[best] = (prev, "model") if isinstance(prev, str) else "model"
    return P(*entries)


def param_pspecs(cfg, mesh):
    """PartitionSpec tree matching ``init_params(cfg, ...)``'s structure,
    from the param defs' shapes and logical axes (nothing is drawn)."""
    from ..models.model import map_param_defs

    return map_param_defs(lambda leaf: spec_for(leaf.axes, leaf.shape, mesh, cfg.strategy),
                          cfg)


def batch_axes(mesh, *, strategy: str = "fsdp_tp", batch: int | None = None) -> tuple:
    """Mesh axes the batch dim shards over.

    zero3 spreads the batch over every axis that divides it (the model axis
    carries data parallelism instead of TP)."""
    cands = ("pod", "data", "model") if strategy == "zero3" else BATCH_AXES
    sizes = axis_sizes(mesh)
    axes: list[str] = []
    size = 1
    for a in cands:
        if a not in sizes:
            continue
        if batch is not None and batch % (size * sizes[a]):
            continue
        axes.append(a)
        size *= sizes[a]
    return tuple(axes)


def batch_pspec(mesh, rank: int = 2, *, strategy: str = "fsdp_tp",
                batch: int | None = None) -> P:
    return P(batch_axes(mesh, strategy=strategy, batch=batch), *([None] * (rank - 1)))


def data_pspecs(cfg, mesh, specs: dict) -> dict:
    """Specs for a train/prefill input-spec dict (tokens/labels/context)."""
    out = {}
    for k, v in specs.items():
        if k == "cache":
            out[k] = cache_pspecs(cfg, mesh, v)
        else:
            out[k] = batch_pspec(mesh, rank=len(v.shape), strategy=cfg.strategy,
                                 batch=v.shape[0])
    return out


def serve_batch_entry(mesh, batch: int):
    """The spec entry of a served batch's rows: the batch axes where their
    product divides ``batch``, else None (every rank holds every row: the
    long_500k case, batch 1).  ``cache_pspecs``' rule."""
    b_axes = batch_axes(mesh)
    b_size = math.prod(axis_sizes(mesh)[a] for a in b_axes)
    return b_axes if batch % b_size == 0 else None


def serve_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a served batch ``x`` [B, ...] (tokens, context),
    by ``serve_batch_entry``."""
    return shard(x, P(serve_batch_entry(mesh, x.shape[0])), mesh)


def cache_pspecs(cfg, mesh, cache_shapes):
    """Specs mirroring ``init_cache``'s structure (``{"pos", "units"}``).

    Batch shards over ("pod","data") when it divides; otherwise (long_500k,
    batch 1) the attention-cache *sequence* axis shards over "data" and
    recurrent-state inner dims shard over "model" where divisible.  The
    port's cache has the reference's leaves, dims and dtypes, one unit
    position's tuple each (the reservoir's ``s_last`` is stored, and
    derived from ``s_prev`` on use), so the reference's per-kind specs map
    leaf for leaf.
    """
    sizes = axis_sizes(mesh)
    kinds = [blk.mixer for blk in cfg.unit]

    batch = None
    for unit_cache in cache_shapes["units"]:
        batch = unit_cache[0].shape[1]
        break
    b_entry = None if batch is None else serve_batch_entry(mesh, batch)
    shard_batch = b_entry is not None

    def b_ax():
        return b_entry

    model = sizes.get("model", 0)

    def inner_ax(d):
        return "model" if (model and d % model == 0) else None

    units_specs = []
    for kind, unit_cache in zip(kinds, cache_shapes["units"]):
        if kind in ("attn", "cross_attn"):
            k_sh = unit_cache[0].shape  # [U, B, S, KV, hd]
            kv_ax = "model" if (model and k_sh[3] % model == 0) else None
            s_axes = []
            if not shard_batch:
                s_axes.append("data")
            if kv_ax is None and model:
                s_axes.append("model")
            s_div = math.prod(sizes[a] for a in s_axes) if s_axes else 1
            s_entry = tuple(s_axes) if (s_axes and k_sh[2] % s_div == 0) else None
            spec = P(None, b_ax(), s_entry, kv_ax, None)
            units_specs.append((spec, spec))
        elif kind == "mamba":
            conv_sh, h_sh = unit_cache[0].shape, unit_cache[1].shape
            units_specs.append((P(None, b_ax(), None, inner_ax(conv_sh[3])),
                                P(None, b_ax(), inner_ax(h_sh[2]), None)))
        elif kind == "mlstm":
            conv_sh, c_sh, n_sh, _m_sh = (u.shape for u in unit_cache)
            units_specs.append((P(None, b_ax(), None, inner_ax(conv_sh[3])),
                                P(None, b_ax(), None, inner_ax(c_sh[3]), None),
                                P(None, b_ax(), None, inner_ax(n_sh[3])),
                                P(None, b_ax(), None)))
        elif kind == "slstm":
            units_specs.append((P(None, b_ax(), inner_ax(unit_cache[0].shape[2])),
                                P(None, b_ax(), inner_ax(unit_cache[1].shape[2])),
                                P(None, b_ax(), None),
                                P(None, b_ax(), inner_ax(unit_cache[3].shape[2]))))
        elif kind == "reservoir":
            units_specs.append((P(None, b_ax(), None, None), P(None, b_ax(), None)))
        else:
            raise ValueError(kind)
    return {"pos": P(), "units": tuple(units_specs)}


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of this rank's block of an array of ``shape`` under
    ``spec`` (each dim divided by its entry's block count)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = shard_count(entry, mesh)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not divide into {n} blocks "
                             f"under {spec}")
        out[dim] //= n
    return tuple(out)


def fit_spec(mesh, shape, *entries) -> P:
    """``entries`` as a spec for an array of ``shape`` on ``mesh``: each
    dim keeps, in order, the axes of its entry that the mesh has and whose
    running product divides the dim (the rule of ``batch_axes(batch=...)``);
    the dim is replicated over the rest."""
    sizes = axis_sizes(mesh)
    out = []
    for dim, entry in zip(shape, entries):
        kept, size = [], 1
        for a in entry_axes(entry):
            if a in sizes and dim % (size * sizes[a]) == 0:
                kept.append(a)
                size *= sizes[a]
        out.append(tuple(kept) if kept else None)
    return P(*out)


def maybe_shard(x, *spec_entries):
    """``x`` when no mesh is active; under a mesh, this rank's block of the
    full tensor ``x`` under ``fit_spec(mesh, x.shape, *spec_entries)``."""
    mesh = active_mesh()
    if mesh is None:
        return x
    return shard(x, fit_spec(mesh, x.shape, *spec_entries), mesh)


# --------------------------------------------------------------------------
# Shards
# --------------------------------------------------------------------------


def _coords(mesh) -> dict[str, int]:
    """This rank's coordinate along each axis of a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"shards and collectives need a DeviceMesh, not {mesh!r}")
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def shard_count(entry, mesh) -> int:
    """How many blocks one spec entry cuts its dim into."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in entry_axes(entry))


def block_index(entry, mesh) -> int:
    """This rank's block along a dim cut by one spec entry (row-major over
    its axes, in the entry's order)."""
    coords = _coords(mesh)
    sizes = axis_sizes(mesh)
    idx = 0
    for a in entry_axes(entry):
        idx = idx * sizes[a] + coords[a]
    return idx


def shard(full: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: a tensor of its own
    (never a view into ``full``), so the full tensor can be freed."""
    out = full
    for dim, entry in enumerate(spec):
        if not entry_axes(entry):
            continue
        idx = block_index(entry, mesh)
        n = shard_count(entry, mesh)
        if full.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not divide into {n} "
                             f"blocks under {spec}")
        step = full.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's block under ``spec``: an
    all-gather over each sharded dim's axes, the last axis of an entry
    first (so the blocks land in the entry's row-major order)."""
    out = local
    for dim, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            out = all_gather(out, a, mesh, dim=dim)
    return out


def tree_shard(tree, spec_tree, mesh):
    """``shard`` over a tree of tensors and its spec tree (``None`` holds
    no leaf)."""
    return _tree_zip(lambda t, s: shard(t, s, mesh), tree, spec_tree)


def tree_gather(tree, spec_tree, mesh):
    return _tree_zip(lambda t, s: gather(t, s, mesh), tree, spec_tree)


def spec_leaves(spec_tree) -> list:
    """The specs of a spec tree in the reference's leaf order (dict keys
    sorted, sequences in order; a ``P`` is one leaf), to pair with
    ``optim.adamw.tree_leaves`` of the tree it describes."""
    if spec_tree is None:
        return []
    if isinstance(spec_tree, dict):
        return [s for k in sorted(spec_tree) for s in spec_leaves(spec_tree[k])]
    if isinstance(spec_tree, (list, tuple)) and not isinstance(spec_tree, P):
        return [s for item in spec_tree for s in spec_leaves(item)]
    return [spec_tree]


def _tree_zip(fn, tree, spec_tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_zip(fn, v, spec_tree[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_tree_zip(fn, v, s) for v, s in zip(tree, spec_tree, strict=True))
    return fn(tree, spec_tree)


# --------------------------------------------------------------------------
# Recording collectives
# --------------------------------------------------------------------------

# The open recorders, process-wide: a backward's collectives run on
# autograd's device threads, which a context variable set here does not reach.
_RECORDERS: list[list] = []


@contextlib.contextmanager
def record_collectives():
    """Collect every collective issued in the extent, the backward's on
    autograd's threads too, as a dict ``{"kind", "bytes", "group",
    "axis"}``: ``bytes`` is the result's size on this rank (the reference's
    HLO result-shape convention), ``group`` the number of ranks taking
    part, ``axis`` the mesh axis it ran over (a send's: the axis of its
    permute)."""
    events: list[dict] = []
    _RECORDERS.append(events)
    try:
        yield events
    finally:
        del _RECORDERS[next(i for i, e in enumerate(_RECORDERS) if e is events)]


def _record(kind: str, n_bytes: int, group_size: int, axis: str | None = None) -> None:
    for events in _RECORDERS:
        events.append({"kind": kind, "bytes": n_bytes, "group": group_size, "axis": axis})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, axes, mesh, *, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` in place over the ranks of ``axes`` (a name or a tuple),
    one all-reduce an axis, by ``op`` ("sum" or "max"); returns ``x``."""
    for a in entry_axes(axes):
        g = mesh.get_group(a)
        _record("all-reduce", _nbytes(x), g.size(), a)
        dist.all_reduce(x, op=_REDUCE_OPS[op], group=g)
    return x


def all_gather(x: torch.Tensor, axis: str, mesh, *, dim: int = 0) -> torch.Tensor:
    """The blocks ``x`` of every rank of ``axis``, concatenated along
    ``dim`` in rank order."""
    g = mesh.get_group(axis)
    n = g.size()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _record("all-gather", n * _nbytes(x), n, axis)
    dist.all_gather(parts, x, group=g)
    return torch.cat(parts, dim=dim)


def reduce_scatter(x: torch.Tensor, axis: str, mesh, *, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, cut into the axis's
    blocks along ``dim``: this rank's block (the adjoint of
    ``all_gather``)."""
    g = mesh.get_group(axis)
    n = g.size()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide into {n} blocks")
    parts = [t.contiguous() for t in x.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    _record("reduce-scatter", _nbytes(out), n, axis)
    dist.reduce_scatter(out, parts, group=g)
    return out


def broadcast(x: torch.Tensor, axis: str, mesh, *, src: int) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` of ``axis``, in place on
    every rank of the axis."""
    g = mesh.get_group(axis)
    _record("broadcast", _nbytes(x), g.size(), axis)
    dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
    return x


def send_recv(send: torch.Tensor | None, recv: torch.Tensor | None, axis: str, mesh, *,
              to: int | None, frm: int | None) -> None:
    """Send ``send`` to coordinate ``to`` of ``axis`` and receive ``recv``
    from coordinate ``frm``, both posted before either is waited on (a
    pipeline's collective permute).

    Under gloo a CUDA tensor goes through the host (module doc): ``send``
    by a blocking copy, complete before gloo's thread reads it, and
    ``recv`` from a fresh host buffer after the wait."""
    g = mesh.get_group(axis)
    staged = dist.get_backend(g) == "gloo"
    works, landing = [], recv
    if send is not None:
        _record("collective-permute", _nbytes(send), 2, axis)
        out = send.contiguous()
        if staged and out.is_cuda:
            out = out.cpu()
        works.append(dist.isend(out, dst=dist.get_global_rank(g, to), group=g))
    if recv is not None:
        if staged and recv.is_cuda:
            landing = torch.empty(recv.shape, dtype=recv.dtype)
        works.append(dist.irecv(landing, src=dist.get_global_rank(g, frm), group=g))
    for w in works:
        w.wait()
    if landing is not recv:
        recv.copy_(landing)


def coordinate(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return _coords(mesh)[axis]


# --------------------------------------------------------------------------
# The plan (module doc)
# --------------------------------------------------------------------------

# Logical axes whose "model" block a block computes over.
_TP_AXES = frozenset({"heads", "kv", "mlp", "vocab", "expert"})
# Single leaves gathered whole although their axis is a TP axis (module doc).
_WHOLE_LEAVES = ("mlp/router", "mixer/b_i", "mixer/b_f")


def _replicated_mixer(cfg, blk, mesh) -> bool:
    """An mLSTM block where "model" does not divide d_in runs replicated
    (module doc)."""
    model = _axis_size(mesh, "model")
    return blk.mixer == "mlstm" and model > 1 and (cfg.d_model * cfg.mlstm_expand) % model != 0


def use_pspecs(cfg, mesh, *, tp: bool = True):
    """The spec tree of the params as the blocks use them: the "model"
    entry of each local leaf, no other entry (``param_pspecs``'
    structure); with ``tp`` False (the rows cut over "model") no entry."""
    from ..models.model import _ENCODER_BLOCK, param_logical_axes

    specs, axes = param_pspecs(cfg, mesh), param_logical_axes(cfg)

    def use(spec, logical, whole):
        return P(*("model" if tp and not whole and entry == "model" and ax in _TP_AXES
                   else None for entry, ax in zip(spec, logical, strict=True)))

    def leaves(spec_d, axes_d, blk=None):
        whole = blk is not None and _replicated_mixer(cfg, blk, mesh)
        return {k: use(s, axes_d[k], k in _WHOLE_LEAVES or (whole and k.startswith("mixer/")))
                for k, s in spec_d.items()}

    out = {"embed": leaves(specs["embed"], axes["embed"]),
           "units": tuple(leaves(s, a, blk) for s, a, blk in zip(specs["units"], axes["units"],
                                                                   cfg.unit, strict=True)),
           "final_norm": leaves(specs["final_norm"], axes["final_norm"])}
    if "encoder" in specs:
        enc, enc_axes = specs["encoder"], axes["encoder"]
        out["encoder"] = {
            "units": (leaves(enc["units"][0], enc_axes["units"][0], _ENCODER_BLOCK),),
            "final_norm": leaves(enc["final_norm"], enc_axes["final_norm"])}
    return out


def use_labels(cfg, mesh):
    """``param_pspecs``' tree with each leaf labelled "local" (its use keeps
    its "model" block, or no axis shards it) or "gathered" (module doc)."""
    def label(spec, use):
        kept = any(entry_axes(e) for e in use)
        return "local" if kept or not any(entry_axes(e) for e in spec) else "gathered"

    return _tree_zip(label, param_pspecs(cfg, mesh), use_pspecs(cfg, mesh))


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; the gradient all-reduced over
    "model"."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.reduce(g.clone(memory_format=torch.contiguous_format), "model"), None


class _SumModel(torch.autograd.Function):
    """Megatron's g: all-reduce over "model" forward; the gradient passes
    as it is (what follows runs alike on every model rank)."""

    @staticmethod
    def forward(ctx, x, plan):
        return plan.reduce(x.clone(memory_format=torch.contiguous_format), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumRows(torch.autograd.Function):
    """All-reduce over ``axes`` (those that cut the rows) forward and
    backward: the adjoint of a sum is the sum."""

    @staticmethod
    def forward(ctx, x, axes, plan):
        ctx.axes, ctx.plan = axes, plan
        return plan.reduce(x.clone(memory_format=torch.contiguous_format), axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.reduce(g.clone(memory_format=torch.contiguous_format),
                               ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather of the tensors ``xs`` over ``axis``, each along its dim
    of ``dims``, in one collective (their blocks flattened and joined);
    the backward is ``kind``: "slice" (this rank's block of each
    gradient) or "reduce-scatter", in one collective too (module doc).
    The tensors share a dtype."""

    @staticmethod
    def forward(ctx, axis, dims, kind, plan, *xs):
        if kind not in ("slice", "reduce-scatter"):
            raise ValueError(f"a gather's backward is slice or reduce-scatter, not {kind!r}")
        ctx.axis, ctx.dims, ctx.kind, ctx.plan = axis, dims, kind, plan
        ctx.shapes = [x.shape for x in xs]
        n = plan.sizes[axis]
        flat = all_gather(torch.cat([x.reshape(-1) for x in xs]), axis, plan.mesh).view(n, -1)
        out, off = [], 0
        for x, dim in zip(xs, dims, strict=True):
            blocks = flat[:, off:off + x.numel()].reshape(n, *x.shape)
            out.append(torch.cat(blocks.unbind(0), dim=dim))
            off += x.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        plan, axis, n = ctx.plan, ctx.axis, ctx.plan.sizes[ctx.axis]
        if ctx.kind == "slice":
            own = [g.narrow(dim, plan.coords[axis] * shape[dim], shape[dim])
                   .clone(memory_format=torch.contiguous_format)
                   for g, dim, shape in zip(grads, ctx.dims, ctx.shapes, strict=True)]
        else:
            # each rank's blocks of every gradient, joined as the forward joined them
            rows = torch.cat([torch.stack(g.chunk(n, dim=dim)).reshape(n, -1)
                              for g, dim in zip(grads, ctx.dims, strict=True)], dim=1)
            mine = reduce_scatter(rows, axis, plan.mesh).reshape(-1)
            own = list(mine.split([shape.numel() for shape in ctx.shapes]))
            own = [t.view(shape) for t, shape in zip(own, ctx.shapes, strict=True)]
        return (None, None, None, None, *own)


class Plan:
    """A step on this rank of ``mesh`` (a ``DeviceMesh``): the params'
    storage specs (``pspecs``), the layout each leaf is used in
    (``uses``), the axes that cut the rows (``row_axes``), and the
    collectives its blocks run (module doc).  The model's sharded routes
    take it as an argument; nothing reads the active mesh.

    ``train``: a train step's plan, whose logits stay this rank's vocab
    block.  ``rows``: the rows a step's microbatch holds in all (default:
    a cut by every batch axis); the batch axes whose running product
    divides them cut them.
    """

    def __init__(self, cfg, mesh, *, train: bool = False, rows: int | None = None):
        from ..models.model import activation_axes

        self.cfg, self.mesh, self.train = cfg, mesh, train
        self.sizes = axis_sizes(mesh)
        self.coords = _coords(mesh)
        self.pspecs = param_pspecs(cfg, mesh)
        axes = tuple(a for a in (activation_axes(cfg) if train else BATCH_AXES)
                     if a in self.sizes)
        if rows is not None:
            axes = entry_axes(fit_spec(mesh, (rows,), axes)[0])
        self.row_axes = tuple(a for a in axes if self.sizes[a] > 1)
        self.uses = use_pspecs(cfg, mesh, tp="model" not in self.row_axes)
        self.tp = 1 if "model" in self.row_axes else self.sizes.get("model", 1)
        self.tp_rank = self.coords.get("model", 0) if self.tp > 1 else 0
        # the blocks the batch axes cut a served batch into, where they divide it
        self.row_blocks = math.prod(self.sizes[a] for a in batch_axes(mesh))

    def leaves(self, local: dict, path: tuple, index: int | None = None) -> dict:
        """The leaves of ``local`` (the stored blocks of the params subtree
        at ``path`` of the spec trees; with ``index``, unit ``index`` of its
        stacked leaves) in the layout their block uses: each gathered over
        the axes its spec names and its use does not (``gather_to``), the
        leaves' k-th gathers over one axis in one collective."""
        specs, uses = self.pspecs, self.uses
        for key in path:
            specs, uses = specs[key], uses[key]
        out, steps = {}, {}
        for name, t in local.items():
            spec, use = specs[name], uses[name]
            if index is not None:
                t, spec, use = t[index], P(*spec[1:]), P(*use[1:])
            out[name], steps[name] = t, self._gathers(spec, use)
        for k in range(max((len(v) for v in steps.values()), default=0)):
            for axis in self.sizes:                          # one order on every rank
                names = [nm for nm, st in steps.items() if len(st) > k and st[k][1] == axis]
                if names:
                    got = self._gather([out[nm] for nm in names], axis,
                                       [steps[nm][k][0] for nm in names])
                    out.update(zip(names, got))
        return out

    def gather_to(self, t: torch.Tensor, spec: P, use: P) -> torch.Tensor:
        """``t`` (a block under ``spec``) gathered over every axis of
        ``spec`` that ``use`` drops (``_gathers``)."""
        for dim, axis in self._gathers(spec, use):
            (t,) = self._gather([t], axis, [dim])
        return t

    def _gathers(self, spec: P, use: P) -> list:
        """The (dim, axis) gathers that take a block under ``spec`` to the
        layout ``use``, in ``gather``'s order (dims in order, an entry's
        last axis first); axes of one rank move nothing and are left out."""
        out = []
        for dim, entry in enumerate(spec):
            kept = entry_axes(use[dim]) if dim < len(use) else ()
            if kept and kept != entry_axes(entry):
                raise ValueError(f"dim {dim}: a use {use} keeps part of the entry {entry}")
            if not kept:
                out += [(dim, a) for a in reversed(entry_axes(entry)) if self.sizes[a] > 1]
        return out

    def _gather(self, xs: list, axis: str, dims: list) -> tuple:
        """``xs`` all-gathered over ``axis`` along ``dims`` in one
        collective: a gather over an axis that cuts the rows
        reduce-scatters its gradient, over any other axis slices it."""
        kind = "reduce-scatter" if axis in self.row_axes else "slice"
        return _Gather.apply(axis, tuple(dims), kind, self, *xs)

    def block_index(self, entry) -> int:
        """This rank's block along a dim cut by ``entry`` (row-major over
        its axes)."""
        return block_index(entry, self.mesh)

    def reduce(self, x: torch.Tensor, axes, *, op: str = "sum") -> torch.Tensor:
        """``all_reduce`` in place over those of ``axes`` with more than one
        rank (no autograd)."""
        live = tuple(a for a in entry_axes(axes) if self.sizes[a] > 1)
        return all_reduce(x, live, self.mesh, op=op) if live else x

    def sum_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g (module doc): the partial sums of a row-parallel
        product added over "model"."""
        return _SumModel.apply(x, self) if self.tp > 1 else x

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f (module doc): ``x``, whose gradient is summed over
        "model"."""
        return _CopyToModel.apply(x, self) if self.tp > 1 else x

    def gather_model(self, x: torch.Tensor, dim: int, backward: str) -> torch.Tensor:
        """The "model" ranks' blocks of ``x`` joined along ``dim``; its
        gradient ``backward`` ("slice" or "reduce-scatter", module doc)."""
        return _Gather.apply("model", (dim,), backward, self, x)[0] if self.tp > 1 else x

    def gather_models(self, xs: tuple, dims: tuple, backward: str) -> tuple:
        """``gather_model`` of each of ``xs`` (one dtype) along its dim of
        ``dims``, in one collective."""
        return _Gather.apply("model", dims, backward, self, *xs) if self.tp > 1 else xs

    def mean_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks of the axes that cut the rows
        (a mean over each rank's equal share of rows is the whole batch's
        mean), its gradient the adjoint's."""
        if not self.row_axes:
            return x
        n = math.prod(self.sizes[a] for a in self.row_axes)
        return _SumRows.apply(x, self.row_axes, self) / n

    def global_norm(self, grads: list) -> torch.Tensor:
        """The f32 L2 norm of the gradient whose blocks ``grads`` (in
        ``tree_leaves`` order) this rank holds: each leaf's square sum
        counted on the first rank of every axis its spec does not name, so
        a replicated block counts once, then summed over every axis."""
        sums = []
        for g, spec in zip(grads, spec_leaves(self.pspecs), strict=True):
            named = {a for e in spec for a in entry_axes(e)}
            if all(self.coords[a] == 0 for a in self.sizes if a not in named):
                sums.append(torch.sum(torch.square(g.to(torch.float32))))
        # optim.adamw.global_norm's sum where this rank counts every leaf
        total = torch.sum(torch.stack(sums)) if sums else \
            torch.zeros((), dtype=torch.float32, device=grads[0].device)
        return torch.sqrt(self.reduce(total, tuple(self.sizes)))


__all__ = ["AbstractMesh", "BATCH_AXES", "P", "Plan", "active_mesh", "all_gather",
           "all_reduce", "axis_sizes", "batch_axes", "batch_pspec", "broadcast",
           "cache_pspecs", "coordinate", "data_pspecs", "entry_axes", "fit_spec", "gather",
           "local_shape", "maybe_shard", "param_pspecs", "record_collectives",
           "reduce_scatter", "send_recv", "serve_batch_entry", "serve_rows", "shard",
           "shard_count", "spec_for", "spec_leaves", "tree_gather", "tree_shard",
           "use_labels", "use_mesh", "use_pspecs"]
