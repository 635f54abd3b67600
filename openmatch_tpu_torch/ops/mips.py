"""Exact maximum-inner-product search (MIPS) in PyTorch.

Port of ``openmatch_tpu/ops/mips.py``, on one device or over the ranks of a
``parallel.mesh.Mesh``:

- ``exact_search``: chunked running top-k over [Q, D] x [N, D]; the plain
  path, and the fallback of the kernel path for tiny corpora. ``method``
  picks each chunk's top-k as the JAX package's ``_chunk_topk`` does.
- ``gather_row_slices`` and ``_select_groups``: the exact max-pyramid
  selection of the kernel path (``ops/cuda_mips.py``), on ``torch.topk``
  and ``torch.gather``.
- ``_hier_topk``, ``_hier2_topk``, ``_pyramid_topk``: exact two-level,
  three-level and max-pyramid top-k over a score matrix (``_hier_topk`` is
  also the fallback of ``hier2_search`` for small corpora).
- ``Searcher``: a fixed index answering repeated query batches; with a
  mesh, partition "docs" (``sharded_search``: each rank holds and searches
  its row shard, the candidates are all-gathered and merged) or "queries"
  (``query_sharded_search``: each rank holds the whole index and searches
  its slice of the queries, the answers are all-gathered).

The pyramid uses a uniform fanout (8 unless the caller passes another,
as the hier2 paths may) and adds a level while ``width // fanout > k``; a
caller may also force JAX's finest-first tuple of per-level fanouts. The
TPU package's cost model that picked the depth (``_plan_pyramid``) was
fitted on TPU timings and is not carried over; selection is exact at any
depth.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.mesh import DATA_AXIS, Mesh, all_gather

NEG = torch.finfo(torch.float32).min  # pallas_mips masks with this, not -inf
FANOUT = 8


def _chunk_topk(scores: torch.Tensor, k: int,
                method: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk's top-k by JAX's ``_chunk_topk`` names: "hier", "hier2",
    "pyramid", and ``torch.topk`` for any other name. "approx" (JAX's
    ``approx_max_k`` at recall_target=0.99) is ``torch.topk`` too: exact,
    which meets that recall contract."""
    if method == "hier":
        return _hier_topk(scores, k)
    if method == "hier2":
        return _hier2_topk(scores, k)
    if method == "pyramid":
        return _pyramid_topk(scores, k)
    return torch.topk(scores, k, dim=1)


def exact_search(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    k: int = 100,
    chunk_size: int = 0,
    valid_rows: Optional[int] = None,
    method: str = "topk",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k inner products. queries [Q, D], corpus [N, D] on one device.

    Returns (scores [Q, min(k, N)] fp32 sorted descending, indices int64).
    Products are taken in fp32 (both operands upcast), chunk by chunk, and
    merged into a running top-k, so the [Q, N] score matrix is never held.
    Rows >= ``valid_rows`` score -inf.

    ``method`` selects each chunk's top-k (``_chunk_topk``): "hier",
    "hier2", "pyramid", or ``torch.topk`` for "topk", "approx" and any other
    name. Every method is exact, so the answers agree above the k-th
    score's tie band; the default is the port's plain ``torch.topk`` where
    the JAX package defaults to "hier2"."""
    Q, D = queries.shape
    N = corpus.shape[0]
    k = min(k, N)
    if chunk_size <= 0:
        # fp32 staging of one chunk stays near 256 MiB at any Q and D
        chunk_size = max(1024, (64 * 2**20) // max(Q + D, 1))
    chunk_size = min(chunk_size, max(N, 1))
    limit = N if valid_rows is None else min(int(valid_rows), N)
    q = queries.float()
    best_s = torch.full((Q, k), float("-inf"), device=queries.device)
    best_i = torch.zeros((Q, k), dtype=torch.int64, device=queries.device)
    for lo in range(0, N, chunk_size):
        hi = min(lo + chunk_size, N)
        s = q @ corpus[lo:hi].float().T
        if limit < hi:
            s[:, max(limit - lo, 0):] = float("-inf")
        cs, ci = _chunk_topk(s, min(k, hi - lo), method)
        cat_s = torch.cat([best_s, cs], dim=1)
        cat_i = torch.cat([best_i, ci + lo], dim=1)
        best_s, pos = torch.topk(cat_s, k, dim=1)
        best_i = torch.gather(cat_i, 1, pos)
    return best_s, best_i


def _hier_topk(scores: torch.Tensor, k: int,
               group: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of scores [Q, C] via two-level selection: top-k of the
    maxima of ``group`` consecutive columns, then an exact re-rank of the
    k * group member columns. Any top-k column lies in a group whose max
    is >= the k-th score, and at most k groups have one, so the selected
    groups cover the top k. Returns (scores [Q, k], column ids int64)."""
    Q, C = scores.shape
    n_groups = C // group
    if C % group or n_groups <= k:
        return torch.topk(scores, k, dim=1)
    grouped = scores.view(Q, n_groups, group)
    _, gi = torch.topk(grouped.amax(-1), k, dim=1)  # [Q, k] group ids
    return _members(grouped, gi, k, group)


def _members(grouped: torch.Tensor, gi: torch.Tensor, k: int,
             group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of the member columns of groups gi [Q, k] of grouped
    [Q, n_groups, group]: (scores [Q, k], column ids int64)."""
    Q = grouped.shape[0]
    cand = torch.gather(grouped, 1, gi[:, :, None].expand(-1, -1, group))
    cand_idx = gi[:, :, None] * group + torch.arange(group,
                                                     device=gi.device)
    s, pos = torch.topk(cand.reshape(Q, k * group), k, dim=1)
    return s, torch.gather(cand_idx.reshape(Q, k * group), 1, pos)


def _hier2_topk(scores: torch.Tensor, k: int,
                group: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via three-level selection: the maxima of ``group``
    columns, then of 8 groups (supergroups); the top k supergroups, the
    top k of their 8 k member groups, then the k * group member columns.
    The covering argument of ``_hier_topk`` holds at each level. Widths
    that no supergroup fits, or with <= k supergroups, take
    ``_hier_topk``."""
    Q, C = scores.shape
    sg = 8 * group
    n_super = C // sg
    if C % sg or n_super <= k:
        return _hier_topk(scores, k, group)
    grouped = scores.view(Q, C // group, group)
    gmax = grouped.amax(-1).view(Q, n_super, 8)  # [Q, C / sg, 8]
    _, si = torch.topk(gmax.amax(-1), k, dim=1)  # supergroup ids
    member_g = torch.gather(gmax, 1, si[:, :, None].expand(-1, -1, 8))
    member_ids = si[:, :, None] * 8 + torch.arange(8, device=scores.device)
    _, pos = torch.topk(member_g.reshape(Q, 8 * k), k, dim=1)
    gi = torch.gather(member_ids.reshape(Q, 8 * k), 1, pos)  # group ids
    return _members(grouped, gi, k, group)


def _pyramid_topk(scores: torch.Tensor, k: int, group: int = 8,
                  fanout: int = FANOUT) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k via group maxima, max-pyramid group selection
    (``_select_groups``) and an exact re-rank of the k * group member
    columns. Widths with ``n_groups // fanout <= k`` take ``_hier_topk``."""
    Q, C = scores.shape
    n_groups = C // group
    if C % group or n_groups // fanout <= k:
        return _hier_topk(scores, k, group)
    grouped = scores.view(Q, n_groups, group)
    gi = _select_groups(grouped.amax(-1), k, fanout)
    return _members(grouped, gi, k, group)


def gather_row_slices(arr: torch.Tensor, starts: torch.Tensor,
                      size: int) -> torch.Tensor:
    """out[q, j, :] = arr[q, starts[q, j] : starts[q, j] + size].

    Every start is a multiple of ``size`` (callers pass ``parent * size``).
    When ``size`` divides the width this is one gather of whole slabs, with
    out-of-range slabs clamped as in the JAX version. When it does not,
    the members past the last column read as ``finfo(float32).min``: the
    value the JAX pyramid pads a ragged level with."""
    Q, W = arr.shape
    if W % size == 0:
        slab = (starts // size).clamp(0, W // size - 1)
        return torch.gather(arr.view(Q, W // size, size), 1,
                            slab[:, :, None].expand(-1, -1, size))
    idx = starts[:, :, None] + torch.arange(size, device=arr.device)
    vals = torch.gather(arr, 1, idx.clamp(0, W - 1).reshape(Q, -1))
    return vals.view(idx.shape).masked_fill(idx >= W, NEG)


def pyramid_fanouts(width: int, k: int, fanout: int = FANOUT) -> tuple:
    """Finest-first fanouts of the max pyramid over ``width`` groups: a
    level is added while ``width // fanout > k``."""
    if fanout < 2:
        raise ValueError(f"fanout must be >= 2, got {fanout}")
    fanouts = []
    while width // fanout > k:
        fanouts.append(fanout)
        width = -(-width // fanout)
    return tuple(fanouts)


def _select_groups(gmax: torch.Tensor, k: int,
                   fanout: Union[int, Tuple[int, ...], None] = FANOUT,
                   l1: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact top-k group selection from per-group maxima [Q, W].

    Builds coarser maxima levels (``fanout`` groups each) until one more
    would hold <= k entries, top-k's the coarsest, then expands level by
    level: gather the fanout*k member maxima of the selected parents and
    keep the top k. Any group of the true top-k has every ancestor's max
    >= the k-th best, and at most k ancestors per level can, so nothing is
    lost at any depth.

    ``fanout``: an int (or None, which is 8) is a uniform fanout whose
    level count follows from W and k; a tuple forces JAX's finest-first
    per-level fanouts exactly (a level may then hold fewer than k entries:
    every one is selected, and the ids are edge-padded to k as in JAX).

    ``l1`` is the precomputed first level [Q, ceil(W / fanouts[0])] (the
    gmax kernel emits it at fanout 8), which skips the widest build pass.
    Returns group ids [Q, k] int64 (not sorted; the caller rescores the
    members)."""
    Q, W = gmax.shape
    if isinstance(fanout, (tuple, list)):
        fanouts = tuple(int(f) for f in fanout)
        if any(f < 2 for f in fanouts):
            raise ValueError(f"fanouts must be >= 2, got {fanouts}")
    else:
        fanouts = pyramid_fanouts(W, k, FANOUT if fanout is None else fanout)
    if l1 is not None:
        if not fanouts or tuple(l1.shape) != (Q, -(-W // fanouts[0])):
            raise ValueError(f"l1 {tuple(l1.shape)} does not fit gmax "
                             f"{tuple(gmax.shape)} at k={k}")
        levels = [gmax, l1]
        build = fanouts[1:]
    else:
        levels = [gmax]
        build = fanouts
    for f in build:
        cur = levels[-1]
        pad = (-cur.shape[1]) % f
        if pad:
            cur = torch.nn.functional.pad(cur, (0, pad), value=NEG)
        levels.append(cur.view(Q, -1, f).amax(-1))

    top = levels[-1]
    _, ids = torch.topk(top, min(k, top.shape[1]), dim=1)
    if ids.shape[1] < k:  # tiny corpus: every coarse entry is selected
        ids = torch.cat([ids, ids[:, -1:].expand(Q, k - ids.shape[1])], 1)
    for lvl, f in zip(reversed(levels[:-1]), reversed(fanouts)):
        member_vals = gather_row_slices(lvl, ids * f, f).reshape(Q, -1)
        _, pos = torch.topk(member_vals, k, dim=1)
        # pos is parent-major (slot * f + m): rebuild the global id from
        # the selected parent instead of carrying ids through the sort
        ids = torch.gather(ids, 1, pos // f) * f + pos % f
    return ids


# ---------------------------------------------------------------------------
# Over a mesh: one process per rank, each answering for all of them
# ---------------------------------------------------------------------------

TILE_ROWS = 256 * 8  # JAX's tile_g blocks of 8 docs: the kernel shards' unit


def shard_rows_for(n_docs: int, n_shards: int, unit: int = 1) -> int:
    """Rows of each of ``n_shards`` equal shards of ``n_docs`` rows, a
    multiple of ``unit``."""
    per_shard = -(-n_docs // n_shards)
    return -(-per_shard // unit) * unit


def _as_tensor(corpus) -> torch.Tensor:
    return torch.from_numpy(corpus) if isinstance(corpus, np.ndarray) \
        else corpus


def shard_corpus(corpus, mesh: Mesh, axis: str = DATA_AXIS,
                 unit: int = 1) -> torch.Tensor:
    """This rank's row shard of a corpus (numpy, a CPU tensor, or a tensor
    on a device): rows ``index * shard_rows`` on, moved to ``mesh.device``
    and zero-padded to ``shard_rows_for(N, ranks, unit)``. Only the shard
    is read and copied to the device, never the whole corpus. ``unit``:
    shard rows are its multiple (``TILE_ROWS`` for the kernel path)."""
    corpus = _as_tensor(corpus)
    N = corpus.shape[0]
    rows = shard_rows_for(N, mesh.size(axis), unit)
    lo = min(mesh.index(axis) * rows, N)
    hi = min(lo + rows, N)
    shard = torch.zeros((rows, corpus.shape[1]), dtype=corpus.dtype,
                        device=mesh.device)
    shard[:hi - lo].copy_(corpus[lo:hi])
    return shard


def _merge(s: torch.Tensor, i: torch.Tensor, mesh: Mesh, axis: str,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ranks' [Q, k_local] candidates all-gathered and merged into the
    top k of every query, on every rank."""
    n, (Q, k_local) = mesh.size(axis), s.shape
    all_s = all_gather(s.contiguous(), mesh, axis).view(n, Q, k_local)
    all_i = all_gather(i.contiguous(), mesh, axis).view(n, Q, k_local)
    all_s = all_s.transpose(0, 1).reshape(Q, n * k_local)
    all_i = all_i.transpose(0, 1).reshape(Q, n * k_local)
    best, pos = torch.topk(all_s, k, dim=1)
    return best, torch.gather(all_i, 1, pos)


def sharded_search(queries: torch.Tensor, corpus: torch.Tensor, k: int,
                   mesh: Mesh, axis: str = DATA_AXIS, chunk_size: int = 0,
                   method: str = "plain", n_valid: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the corpus row-sharded over ``mesh``'s ``axis``
    (JAX ``sharded_search``): ``corpus`` is this rank's shard (equal rows
    on every rank, zero-padded at the end) and ``queries`` every rank's
    same batch. Each rank searches its shard at ``k_local = min(k,
    shard_rows)`` over its valid rows ``clip(n_valid - index * rows, 0,
    rows)`` and adds its id offset; the [ranks, Q, k_local] candidates are
    all-gathered and the top ``min(k, ranks * k_local)`` kept, on every
    rank. ``method`` "kernel" runs ``cuda_mips.plain_topk_valid`` (the
    shard must be a multiple of ``TILE_ROWS``), "plain" ``exact_search``.
    Slots no valid row fills score -inf."""
    rows = corpus.shape[0]
    n = mesh.size(axis)
    total = n * rows if n_valid is None else n_valid
    valid = min(max(total - mesh.index(axis) * rows, 0), rows)
    k_local = min(k, rows)
    k_final = min(k, n * k_local)
    if method == "kernel":
        from .cuda_mips import plain_topk_valid

        s, i = plain_topk_valid(queries, corpus, valid, k_local)
    else:
        s, i = exact_search(queries, corpus, k_local, chunk_size,
                            valid_rows=valid)
    return _merge(s, i + mesh.index(axis) * rows, mesh, axis, k_final)


def _local_queries(queries: torch.Tensor, mesh: Mesh,
                   axis: str) -> torch.Tensor:
    n = mesh.size(axis)
    if queries.shape[0] % n:
        raise ValueError(f"query rows {queries.shape[0]} % shards {n} != 0")
    rows = queries.shape[0] // n
    lo = mesh.index(axis) * rows
    return queries[lo:lo + rows]


def query_sharded_search(queries: torch.Tensor, corpus: torch.Tensor,
                         k: int, mesh: Mesh, axis: str = DATA_AXIS,
                         chunk_size: int = 0, method: str = "plain",
                         n_valid: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the corpus replicated and the queries split over
    ``axis`` (JAX ``query_sharded_search``): each rank searches the whole
    corpus for its contiguous slice of the queries (their count a multiple
    of the axis: pad upstream), and the answers are all-gathered in query
    order. ``method`` "kernel" runs ``cuda_mips.plain_topk_valid`` over a
    ``pad_plain`` corpus, "plain" ``exact_search``."""
    q = _local_queries(queries, mesh, axis)
    valid = corpus.shape[0] if n_valid is None else n_valid
    if method == "kernel":
        from .cuda_mips import plain_topk_valid

        s, i = plain_topk_valid(q, corpus, valid, k)
    else:
        s, i = exact_search(q, corpus, min(k, corpus.shape[0]), chunk_size,
                            valid_rows=valid)
    return (all_gather(s.contiguous(), mesh, axis),
            all_gather(i.contiguous(), mesh, axis))


def _replicated_prep(corpus, mesh: Mesh, n_segs: int):
    """The whole corpus as a ``prepare_plain_corpus`` layout on this rank's
    device, its body in ``n_segs`` segments cut where the one-device
    layout cuts them, each its own allocation: the queries partition's
    segmented index (K4 and K5 run on each rank). A host corpus is copied
    over segment by segment."""
    from .cuda_mips import prepare_plain_corpus

    return prepare_plain_corpus(_as_tensor(corpus), n_segs=n_segs,
                                device=mesh.device)


class Searcher:
    """A fixed index answering repeated query batches.

    ``method``: "kernel" holds the prepared doc-major layout and searches
    it with the gmax kernel, pyramid selection and the gather-rescore
    kernel (``ops/cuda_mips.py``); "plain" runs ``exact_search``; "auto"
    takes "kernel" when the index lies on a CUDA device and "plain" on the
    CPU. The kernel wrappers run their plain PyTorch versions on CPU
    tensors, so "kernel" on the CPU runs the same pipeline without CUDA.

    ``n_segs`` > 1 holds the prepared index as that many segment
    allocations (``prepare_plain_corpus``): the same search, but no single
    allocation holds more than about 1/n_segs of the index. The count is
    clamped to one segment per 256-block tile, as in the JAX package, and
    then to the kernels' 64 with a logged warning; the answers are the
    same at any count. It needs the kernel path, and over a mesh the
    queries partition, as the JAX package's needs its Pallas path.

    ``mesh`` (one process per rank, every rank constructing and calling
    the Searcher alike): ``partition="docs"`` gives each rank its row
    shard of ``axis`` (``shard_corpus``: from a host corpus only the shard
    is copied, so the whole corpus is never on one device) and merges the
    ranks' candidates (``sharded_search``); ``partition="queries"`` holds the whole index on
    every rank and splits each query batch, padded to a multiple of the
    axis (``query_sharded_search``). Every rank returns the whole answer.
    ``last_dispatch`` names the path a search took: "kernel-mesh-docs",
    "kernel-mesh-queries", "kernel-mesh-queries-seg" or
    "plain-mesh-{partition}:plain"."""

    def __init__(self, corpus, k: int = 100, chunk_size: int = 0,
                 method: str = "auto", n_segs: int = 1,
                 mesh: Optional[Mesh] = None, axis: str = DATA_AXIS,
                 partition: str = "docs"):
        if partition not in ("docs", "queries"):
            raise ValueError(f"unknown partition {partition!r}")
        corpus = _as_tensor(corpus)
        device = corpus.device if mesh is None else mesh.device
        if method == "auto":
            method = "kernel" if device.type == "cuda" else "plain"
        if method not in ("kernel", "plain"):
            raise ValueError(f"unknown search method {method!r} "
                             "(auto | kernel | plain)")
        if n_segs > 1 and not (method == "kernel" and (
                mesh is None or partition == "queries")):
            # refuse rather than silently ignore, as the JAX package does:
            # the docs partition already splits the corpus per rank
            raise ValueError(
                f"n_segs={n_segs} requires method='kernel' and either no "
                f"mesh or partition='queries' (got method={method!r}, "
                f"mesh={'set' if mesh is not None else 'None'}, "
                f"partition={partition!r})")
        self.k = k
        self.chunk_size = chunk_size
        self.method = method
        self.mesh, self.axis, self.partition = mesh, axis, partition
        self.device = device
        self.n_segs = n_segs
        self.last_dispatch = None
        self._prep = None
        self.corpus = None
        self.dtype, self.n_docs = corpus.dtype, corpus.shape[0]
        self.dim = corpus.shape[1]
        if mesh is None:
            if method == "kernel":
                from .cuda_mips import prepare_plain_corpus

                self._prep = prepare_plain_corpus(corpus, n_segs=n_segs)
            else:
                self.corpus = corpus
        elif partition == "docs":
            self.corpus = shard_corpus(
                corpus, mesh, axis,
                TILE_ROWS if method == "kernel" else 1)
        elif method == "kernel" and n_segs > 1:
            self._prep = _replicated_prep(corpus, mesh, n_segs)
        elif method == "kernel":
            from .cuda_mips import pad_plain

            self.corpus = pad_plain(corpus, device=device)
        else:
            self.corpus = corpus.to(device)

    def search(self, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # pooled reps are often strided views; the kernels take dense rows
        queries = queries.to(device=self.device, dtype=self.dtype).contiguous()
        if self.mesh is not None:
            return self._mesh_search(queries)
        if self.method == "kernel":
            from .cuda_mips import plain_topk_prepared

            self.last_dispatch = ("kernel-segmented" if self.n_segs > 1
                                  else "kernel") + f":{self.device.type}"
            return plain_topk_prepared(queries, self._prep, self.k)
        self.last_dispatch = f"plain:{self.device.type}"
        return exact_search(queries, self.corpus, self.k, self.chunk_size)

    def _mesh_search(self, queries: torch.Tensor):
        mesh, axis = self.mesh, self.axis
        kernel = self.method == "kernel"
        if self.partition == "docs":
            self.last_dispatch = ("kernel-mesh-docs" if kernel
                                  else "plain-mesh-docs:plain")
            return sharded_search(queries, self.corpus, self.k, mesh, axis,
                                  self.chunk_size, self.method, self.n_docs)
        Q = queries.shape[0]
        q_pad = (-Q) % mesh.size(axis)
        if q_pad:
            queries = torch.cat([queries, queries.new_zeros(
                (q_pad, queries.shape[1]))])
        if self._prep is not None:
            from .cuda_mips import plain_topk_prepared

            self.last_dispatch = "kernel-mesh-queries-seg"
            q = _local_queries(queries, mesh, axis)
            s, i = plain_topk_prepared(q, self._prep, self.k)
            s, i = (all_gather(s.contiguous(), mesh, axis),
                    all_gather(i.contiguous(), mesh, axis))
        else:
            self.last_dispatch = ("kernel-mesh-queries" if kernel
                                  else "plain-mesh-queries:plain")
            s, i = query_sharded_search(queries, self.corpus,
                                        min(self.k, self.n_docs), mesh,
                                        axis, self.chunk_size, self.method,
                                        self.n_docs)
        return s[:Q], i[:Q]
