"""Shared helpers of the indexes (counterpart of
``raft_tpu.neighbors._common``), the pass filters' folding and masks, and
the search pipeline IVF-Flat and IVF-PQ share (:func:`scan_search`).

List layout is host numpy metadata, as in raft_tpu; everything that
touches rows or queries is torch on the index's device.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import validation
from raft_tpu_torch.core.bitset import Bitset, RowFilter, bits_at
from raft_tpu_torch.kernels.toolkit import round_up
from raft_tpu_torch.ops.matrix import select_k_untraced as select_k


def merge_split_lists(centers: np.ndarray, labels: np.ndarray):
    """Collapse split shards (bit-identical duplicated centroids) back to
    their parent list before a re-pack.  Returns (unique_idx — first
    occurrence of each distinct centroid in original order, new_labels)."""
    centers = np.asarray(centers)
    _, first_idx, inverse = np.unique(
        centers, axis=0, return_index=True, return_inverse=True
    )
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    unique_idx = first_idx[order]
    new_labels = rank[np.asarray(inverse).reshape(-1)[np.asarray(labels, np.int64)]]
    return unique_idx, new_labels.astype(np.int64)


def default_max_cap(n_rows: int, n_lists: int) -> int:
    """Per-list capacity bound: 2x the mean occupancy (1.25x at 5e7+ rows),
    rounded to 8."""
    mean = max(1, -(-n_rows // max(1, n_lists)))
    slack_num, slack_den = (5, 4) if n_rows >= 50_000_000 else (2, 1)
    return max(32, round_up(slack_num * mean // slack_den, 8))


def split_oversized_lists(
    labels: np.ndarray, n_lists: int, max_cap: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Relabel members of lists larger than ``max_cap`` into sublists
    appended after the original lists.  Returns (new_labels, center_map)
    where ``center_map[l]`` is the original list whose centroid list ``l``
    shares."""
    labels = np.asarray(labels, np.int64).copy()
    sizes = np.bincount(labels, minlength=n_lists)
    center_map = list(range(n_lists))
    next_id = n_lists
    for l in np.nonzero(sizes > max_cap)[0]:
        members = np.nonzero(labels == l)[0]
        n_parts = -(-len(members) // max_cap)
        for p in range(1, n_parts):
            labels[members[p * max_cap:(p + 1) * max_cap]] = next_id
            center_map.append(int(l))
            next_id += 1
    return labels, np.asarray(center_map, np.int64)


def subsample_trainset(dataset, n_train: int, seed: int):
    """No-replacement row subsample drawn with numpy's generator, so the
    rows are the ones raft_tpu draws for the same seed."""
    n = dataset.shape[0]
    idx = np.sort(np.random.default_rng(seed).choice(n, size=n_train, replace=False))
    if isinstance(dataset, np.ndarray):
        return dataset[idx]
    return dataset[torch.from_numpy(idx).to(dataset.device)]


def compute_list_layout(
    labels: np.ndarray,
    n_lists: int,
    max_cap: Optional[int] = None,
    headroom: bool = False,
):
    """Per-row (list, slot) placement for the padded list layout.  Returns
    (lst [n], slot [n], sizes [n_lists'], center_map [n_lists'], cap); cap
    is the largest list rounded up to 8, plus ~12.5% when ``headroom``,
    never above ``round_up(max_cap, 8)`` (oversized lists are split)."""

    def with_headroom(base: int) -> int:
        cap = base + max(8, base // 8) if headroom else base
        cap = max(8, round_up(cap, 8))
        if max_cap is not None:
            cap = min(cap, round_up(max_cap, 8))
        return max(cap, round_up(max(base, 1), 8))

    labels = np.asarray(labels, np.int64)
    n = labels.shape[0]
    if max_cap is not None:
        labels, center_map = split_oversized_lists(labels, n_lists, max_cap)
        n_lists = len(center_map)
    else:
        center_map = np.arange(n_lists, dtype=np.int64)
    sizes = np.bincount(labels, minlength=n_lists)
    cap = with_headroom(int(sizes.max()) if n else 8)
    order = np.argsort(labels, kind="stable")
    starts = np.zeros(n_lists + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    slot = np.empty(n, np.int64)
    slot[order] = np.arange(n) - starts[labels[order]]
    return labels, slot, sizes.astype(np.int32), center_map, cap


def unpack_lists(list_payload: torch.Tensor, list_index: torch.Tensor):
    """Inverse of the padded packing → (payload, ids, labels), on the
    lists' device."""
    valid = list_index >= 0
    labels = torch.repeat_interleave(
        torch.arange(list_index.shape[0], device=list_index.device), valid.sum(1)
    )
    return list_payload[valid], list_index[valid], labels


def centroid_group_inverse(centers) -> np.ndarray:
    """Group id per list; split shards of one list share a group."""
    _, inverse = np.unique(np.asarray(centers), axis=0, return_inverse=True)
    return np.asarray(inverse).reshape(-1)


def allocate_append_slots(centers, list_sizes, cap, labels, group_inverse=None):
    """(list, slot) for each new row of an in-place append, or None when a
    centroid group is out of spare capacity (the caller repacks).  Rows
    whose shard is full overflow into a sibling shard with space.
    Returns (lists [n], slots [n], counts_new [L]) numpy, or None."""
    sizes = np.asarray(list_sizes).copy()
    labels = np.asarray(labels, np.int64)
    L = np.asarray(centers).shape[0]
    if labels.size and labels.max() >= L:
        return None
    inverse = group_inverse if group_inverse is not None else centroid_group_inverse(centers)
    group_members: dict = {}
    for lst, g in enumerate(inverse):
        group_members.setdefault(int(g), []).append(lst)
    out_list = np.empty_like(labels)
    out_slot = np.empty_like(labels)
    for g in np.unique(inverse[labels]):
        rows = np.nonzero(inverse[labels] == g)[0]
        members = group_members[int(g)]
        if sum(cap - sizes[m] for m in members) < len(rows):
            return None
        i = 0
        for m in members:
            take = min(cap - sizes[m], len(rows) - i)
            if take <= 0:
                continue
            sel = rows[i:i + take]
            out_list[sel] = m
            out_slot[sel] = sizes[m] + np.arange(take)
            sizes[m] += take
            i += take
            if i == len(rows):
                break
    return out_list, out_slot, sizes - np.asarray(list_sizes)


def coarse_scores(queries: torch.Tensor, centers: torch.Tensor, metric: str) -> torch.Tensor:
    """[q, n_lists] probe ranking scores (smaller is closer): one
    ``torch.matmul``, plain XLA in raft_tpu too."""
    if metric == "cosine":
        qn = queries / torch.clamp(torch.linalg.vector_norm(queries, dim=1, keepdim=True), min=1e-12)
        cn = centers / torch.clamp(torch.linalg.vector_norm(centers, dim=1, keepdim=True), min=1e-12)
        return -torch.matmul(qn, cn.T)
    if metric == "inner_product":
        return -torch.matmul(queries, centers.T)
    cnorm = (centers * centers).sum(dim=1)
    return cnorm[None, :] - 2.0 * torch.matmul(queries, centers.T)


def coarse_select(queries: torch.Tensor, centers: torch.Tensor, metric: str,
                  n_probes: int) -> torch.Tensor:
    """Top-``n_probes`` list ids per query [q, n_probes] int32."""
    _, probes = select_k(coarse_scores(queries, centers, metric), n_probes, select_min=True)
    return probes


def resolve_pass_filter(sample_filter, deleted_mask):
    """Fold an optional tombstone mask into the pass-filter convention:
    ``sample_filter`` (a :class:`Bitset` or :class:`RowFilter`) keeps its
    set bits, ``deleted_mask`` (a :class:`Bitset`) excludes its set bits.
    Returns one pass filter, or None.  A RowFilter may cover more ids than
    the tombstones (its extra words pass through); otherwise both must
    cover the same ids (``ValueError``); any other kind of filter raises
    ``TypeError``."""
    if not isinstance(sample_filter, (Bitset, RowFilter, type(None))):
        raise TypeError(f"sample_filter must be a Bitset or a RowFilter, got "
                        f"{type(sample_filter).__name__}")
    if not isinstance(deleted_mask, (Bitset, type(None))):
        raise TypeError(f"deleted_mask must be a Bitset, got {type(deleted_mask).__name__}")
    if deleted_mask is None:
        return sample_filter
    if sample_filter is None:
        return Bitset(~deleted_mask.words, deleted_mask.n_bits)
    live = ~deleted_mask.words.to(sample_filter.words.device)
    nw = live.shape[0]
    if isinstance(sample_filter, RowFilter):
        if sample_filter.n_bits < deleted_mask.n_bits:
            raise ValueError(f"row filter covers {sample_filter.n_bits} ids but "
                             f"deleted_mask covers {deleted_mask.n_bits}")
        words = sample_filter.words.clone()
        words[:, :nw] &= live
        table = sample_filter.table
        if table is not None:
            table = table.clone()
            table[:, :nw] &= live
        return RowFilter(words, sample_filter.n_bits, fid=sample_filter.fid, table=table,
                         pass_count=sample_filter.pass_count)
    if sample_filter.n_bits != deleted_mask.n_bits:
        raise ValueError(f"sample_filter covers {sample_filter.n_bits} ids but "
                         f"deleted_mask covers {deleted_mask.n_bits}")
    return Bitset(sample_filter.words & live, sample_filter.n_bits)


def invalid_mask(ids: torch.Tensor, filter_words=None) -> torch.Tensor:
    """Candidate mask: padding slots (id < 0), and ids whose bit in
    ``filter_words`` is 0 — one word set [W], or a RowFilter's words
    [rows, W] with ids [rows, ...] (then as :func:`invalid_mask_rows`)."""
    if filter_words is not None and filter_words.ndim == 2:
        return invalid_mask_rows(ids, filter_words)
    invalid = ids < 0
    if filter_words is not None:
        invalid = invalid | ~bits_at(filter_words, ids)
    return invalid


def invalid_mask_rows(ids: torch.Tensor, row_words: torch.Tensor) -> torch.Tensor:
    """:func:`invalid_mask` with a word set per row: ids [rows, ...] tested
    against row_words [rows, W], row r by its own words."""
    return ~RowFilter(row_words, row_words.shape[1] * 32).test_rows(ids) | (ids < 0)


def invert_probes(probes: torch.Tensor, n_lists: int, bucket: int):
    """Invert the (query, probe) relation into per-list query buckets.
    Returns (bucket_list [B] int32, bucket_query [B, G] int32 (-1 padded),
    bucket_pair [B, G] int32 — each slot's query-major pair index, B) with
    B = q·p // G + n_lists, raft_tpu's static bound."""
    q, p = probes.shape
    G = bucket
    P = q * p
    dev = probes.device
    pair_list = probes.reshape(P).long()
    pair_query = torch.arange(q, device=dev).repeat_interleave(p)
    order = torch.argsort(pair_list, stable=True)
    sl = pair_list[order]
    sq = pair_query[order]
    first = torch.searchsorted(sl, sl, side="left")
    pos = torch.arange(P, device=dev) - first
    counts = torch.bincount(sl, minlength=n_lists)
    nb = (counts + G - 1) // G
    bucket_off = torch.cumsum(nb, 0) - nb
    pair_bucket = bucket_off[sl] + pos // G
    slot = pos % G
    B = P // G + n_lists
    bucket_list = torch.zeros(B, dtype=torch.int32, device=dev)
    bucket_list[pair_bucket] = sl.to(torch.int32)
    bucket_query = torch.full((B, G), -1, dtype=torch.int32, device=dev)
    bucket_query[pair_bucket, slot] = sq.to(torch.int32)
    bucket_pair = torch.full((B, G), -1, dtype=torch.int32, device=dev)
    bucket_pair[pair_bucket, slot] = order.to(torch.int32)
    return bucket_list, bucket_query, bucket_pair, B


def select_scan_strategy(strategy: str, q: int, n_probes: int, n_lists: int,
                         list_cap: int, row_dim: int, workspace_bytes: int,
                         k: int = 10):
    """Resolve the scan schedule + probe-major sizing, as raft_tpu does:
    probe-major when ``q >= 256`` and ``q·n_probes >= 4·n_lists``.
    Returns (strategy, bucket, bb, q_tile); bucket/bb/q_tile are None for
    query_major."""
    if strategy == "auto":
        strategy = (
            "probe_major" if q >= 256 and q * n_probes >= 4 * n_lists
            else "query_major"
        )
    if strategy != "probe_major":
        return strategy, None, None, None
    per_q = max(1, n_probes * max(k, 1) * 24)
    q_tile = int(np.clip(4 * workspace_bytes // per_q, 256, max(q, 256)))
    reuse = max(1.0, (min(q, q_tile) * n_probes) / max(n_lists, 1))
    bucket = int(np.clip(1 << int(np.ceil(np.log2(reuse))), 16, 512))
    per_b = list_cap * (row_dim * 4 + bucket * 8) + bucket * row_dim * 4
    bb = int(np.clip(workspace_bytes // max(per_b, 1), 1, 64))
    return strategy, bucket, bb, q_tile


def scatter_pair_partials(vs, is_, bucket_pair, q, n_probes, kk):
    """Per-pair top-kk partials [B·G, kk] back in (query, probe) order:
    ([q, n_probes·kk] values, ids).  Padding slots carry bucket_pair -1 and
    are dropped."""
    P = q * n_probes
    flat_pair = bucket_pair.reshape(-1).long()
    dest = torch.where(flat_pair >= 0, flat_pair, torch.full_like(flat_pair, P))
    pair_v = torch.full((P + 1, kk), float("inf"), dtype=torch.float32, device=vs.device)
    pair_i = torch.full((P + 1, kk), -1, dtype=torch.int32, device=vs.device)
    pair_v[dest] = vs
    pair_i[dest] = is_
    return pair_v[:P].reshape(q, n_probes * kk), pair_i[:P].reshape(q, n_probes * kk)


def merge_probe_major_partials(vs, is_, bucket_pair, q, n_probes, kk, k):
    """Merge probe-major partials per query: select_k over [q,
    n_probes·kk] in (query, probe) pair order."""
    pair_v, pair_i = scatter_pair_partials(vs, is_, bucket_pair, q, n_probes, kk)
    return select_k(pair_v, k, select_min=True, input_indices=pair_i)


def probe_major_scan_inputs(probes, q_scan, lists, k: int, bucket: int):
    """Probe inversion of ``probes`` [q, n_probes] and the [B, G, d] gather
    of the scanned query rows ``q_scan`` (the queries themselves for
    IVF-Flat, rotated for IVF-PQ).  ``lists`` is (list_data, list_y2,
    list_index).  Returns (the positional arguments of
    ``ivf_scan_probe_major``, bucket_pair)."""
    q2 = (q_scan * q_scan).sum(dim=1)
    bucket_list, bucket_query, bucket_pair, _ = invert_probes(probes, lists[2].shape[0], bucket)
    bq = bucket_query.long().clamp(min=0)
    q2g = torch.where(bucket_query >= 0, q2[bq], torch.full_like(q2[bq], float("inf")))
    kk = min(int(k), lists[0].shape[1])
    return (bucket_list, q_scan[bq], q2g, *lists, kk), bucket_pair


def query_major_scan_inputs(probes, q_scan, lists, k: int):
    """The positional arguments of ``ivf_scan_query_major`` for the scanned
    rows ``q_scan`` over their ``probes``."""
    return (probes, q_scan, (q_scan * q_scan).sum(dim=1), *lists, int(k))


def qm_query_tile(n_probes: int) -> int:
    """Query block of the query-major search (raft_tpu's rule: bounded
    q_tile·n_probes, a multiple of 8)."""
    return max(8, min(4096, (32_768 // max(1, n_probes)) // 8 * 8))


def identity_fid_tile(n_lists: int, list_cap: int, workspace_bytes: int, n_probes: int) -> int:
    """Query tile of a row filter without a descriptor: each tile packs its
    rows' words as a table of planes [tile, n_lists, cap_w], and the tile
    is bounded so that the planes fit ``workspace_bytes``."""
    plane_bytes = 4 * n_lists * -(-list_cap // 32)
    return max(1, min(qm_query_tile(n_probes), workspace_bytes // plane_bytes))


def scan_search(queries, k: int, n_probes: int, strategy: str, centers, lists,
                metric: str, q_scan_fn, scan_kw: dict, workspace_bytes: int,
                pass_filter=None, probes_fn=None):
    """Coarse select → list scan → merge, the search both IVF indexes run,
    on the schedule raft_tpu's rule picks (:func:`select_scan_strategy`):
    probe-major for large batches, query-major for serving-sized ones.
    ``lists`` is (list_data, list_y2, list_index); ``q_scan_fn`` maps a
    block of raw queries to the rows the lists are scored against;
    ``scan_kw`` carries the scan's storage-leg arguments.  ``probes_fn``
    maps a block of raw queries to the lists it probes ([q, n_probes]
    int32, closest first); by default :func:`coarse_select` ranks the
    ``centers`` (random ball cover ranks its landmarks itself).

    ``pass_filter`` (from :func:`resolve_pass_filter`) picks the scan's
    filter leg, packed once per call as raft_tpu packs it:

    - a :class:`Bitset`: ``pack_list_filter`` words on either schedule;
    - a :class:`RowFilter` (one filter per query) forces the query-major
      schedule; with its descriptor (``table`` / ``fid``) the table is
      packed once (``pack_list_filter_table``) and each query's ``fid``
      rides beside it through the query tiles (the ``query_fid`` leg);
      without one, each query tile packs its own rows' words as planes and
      scans with ``fid`` = 0..tile-1 (:func:`identity_fid_tile`), so that
      it too rides the ``query_fid`` leg and no plain scan runs on the
      card.

    Lists on the card go to the scan kernels, which raise outside their
    envelope (``kk`` up to ``ivf_scan.MAX_KK``); lists on the CPU go to the
    plain versions, at any ``kk``.  A paged index's ``list_data`` is a
    ``store.PagedLists`` (:func:`paged_lists_for_search`), whose device is
    its pool's: the route follows it (the index's own ``list_data`` is then
    a host tensor).  The call stamps ``kernel_path`` "cuda" or "torch".
    Returns raw scores (the caller postprocesses) and ids."""
    from raft_tpu_torch.kernels import ivf_scan as scan_mod
    from raft_tpu_torch.kernels import stamp_kernel_path

    data, _, list_index = lists
    dev = data.device  # a PagedLists' pool device
    if probes_fn is None:
        probes_fn = lambda qt: coarse_select(qt, centers, metric, n_probes)  # noqa: E731
    per_row = isinstance(pass_filter, RowFilter)
    if per_row:
        validation.expects(
            pass_filter.words.shape[0] == queries.shape[0],
            f"row filter has {pass_filter.words.shape[0]} rows for {queries.shape[0]} queries")
        # probe-major scores whole lists against buckets of queries: a
        # per-query filter has no per-list form there
        strategy = "query_major"
    strategy, bucket, _, q_tile = select_scan_strategy(
        strategy, queries.shape[0], n_probes, centers.shape[0], data.shape[1],
        data.shape[2], workspace_bytes, k=k,
    )
    kk = min(k, data.shape[1]) if strategy == "probe_major" else k
    on_card = dev.type == "cuda"
    stamp_kernel_path("cuda" if on_card else "torch")
    lf = None
    if pass_filter is not None and not per_row:
        lf = scan_mod.pack_list_filter(list_index, pass_filter.words.to(dev))
    if strategy == "probe_major":
        scan = scan_mod.ivf_scan_probe_major if on_card else scan_mod.ivf_scan_probe_major_torch

        def run_pm(qt):
            args, bucket_pair = probe_major_scan_inputs(probes_fn(qt), q_scan_fn(qt), lists, k,
                                                        bucket)
            vals, ids = scan(*args, metric=metric, list_filter=lf, **scan_kw)
            return merge_probe_major_partials(
                vals.reshape(-1, kk), ids.reshape(-1, kk), bucket_pair,
                qt.shape[0], n_probes, kk, k,
            )

        return run_query_tiled(run_pm, queries, q_tile)
    scan = scan_mod.ivf_scan_query_major if on_card else scan_mod.ivf_scan_query_major_torch

    def run_qm(qt, planes=None, fid=None):
        args = query_major_scan_inputs(probes_fn(qt), q_scan_fn(qt), lists, k)
        return scan(*args, metric=metric, list_filter=lf if planes is None else planes,
                    query_fid=fid, **scan_kw)

    tile = qm_query_tile(n_probes)
    if not per_row:
        return run_query_tiled(run_qm, queries, tile)
    if pass_filter.table is not None:
        planes = scan_mod.pack_list_filter_table(list_index, pass_filter.table.to(dev))
        return run_query_tiled(lambda qt, fid: run_qm(qt, planes, fid), queries, tile,
                               extras=(pass_filter.fid.to(device=dev, dtype=torch.int32),))

    def run_rows(qt, words):
        fid = torch.arange(qt.shape[0], dtype=torch.int32, device=dev)
        return run_qm(qt, scan_mod.pack_list_filter_table(list_index, words), fid)

    return run_query_tiled(
        run_rows, queries,
        identity_fid_tile(data.shape[0], data.shape[1], workspace_bytes, n_probes),
        extras=(pass_filter.words.to(dev),))


def paged_lists_for_search(index, queries: torch.Tensor, metric: str, n_probes: int):
    """Paged-search prefix shared by ivf_flat / ivf_pq (raft_tpu's
    ``paged_lists_for_search``): key the pager by the probed lists and hand
    back the ``store.PagedLists`` view the scans read through.

    A pool that holds every page pins the identity placement once and skips
    the coarse pass and all per-call bookkeeping: nothing can be evicted,
    so the page table never changes after the pin, and the call costs no
    host synchronisation.  A smaller pool runs the coarse pass, reads the
    unique probed lists back to the host (one synchronisation, as
    raft_tpu's makes one), then calls ``prefetch`` (an advisory hint) and
    ``ensure_resident`` (the blocking admission, on the current stream).
    The scan's own coarse pass repeats this one's selection: the same
    deterministic computation on the same inputs."""
    from raft_tpu_torch.store.paged import PagedLists, pages_for_lists

    tiered = index.paged
    if tiered.slots == tiered.n_pages:
        tiered.pin_identity()
    else:
        probes = coarse_select(queries, index.centers, metric, n_probes)
        lists = torch.unique(probes).cpu().numpy()
        pages = pages_for_lists(lists, tiered.pages_per_list)
        tiered.prefetch(pages)
        tiered.ensure_resident(pages)
    pool, page_slot = tiered.view()
    return PagedLists(pool, page_slot, tiered.pages_per_list)


@contextlib.contextmanager
def search_lists(index, queries: torch.Tensor, metric: str, n_probes: int,
                 list_y2: torch.Tensor):
    """(list_data, list_y2, list_index) for one search of an IVF index,
    held for the ``with`` block in which the caller enqueues its scans.
    A paged index yields the ``PagedLists`` view of
    :func:`paged_lists_for_search`; when its pool holds fewer slots than
    pages, the block runs under the store's ``search_guard``, so that
    searches from several threads (and streams) cannot evict one
    another's pages between admission and scan.  A fully resident pool
    (pinned once) takes no guard."""
    if index.paged is None:
        yield index.list_data, list_y2, index.list_index
        return
    tiered = index.paged
    full = tiered.slots == tiered.n_pages
    with contextlib.nullcontext() if full else tiered.search_guard():
        yield (paged_lists_for_search(index, queries, metric, n_probes), list_y2,
               index.list_index)


def sorted_id_dedup(ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable sort of each row by id plus an adjacent compare: (order — the
    stable argsort, int64; dup — bool in *sorted* space, True at every
    repeat after an id's first occurrence).  Callers gather their payloads
    through ``order`` and demote the ``dup`` slots, so the first occurrence
    in the original layout wins (raft_tpu's ``sorted_id_dedup``)."""
    s, order = torch.sort(ids, dim=-1, stable=True)
    dup = torch.zeros(s.shape, dtype=torch.bool, device=s.device)
    dup[..., 1:] = s[..., 1:] == s[..., :-1]
    return order, dup


def postprocess(v: torch.Tensor, metric: str) -> torch.Tensor:
    """Scan scores → distances: L2 scores already include |q|^2."""
    if metric == "inner_product":
        return -v
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(v, min=0.0))
    return v


def run_query_tiled(run_fn, queries: torch.Tensor, q_tile: int, extras=()):
    """Run ``run_fn(query_block, *extra_blocks) → (v, i)`` over blocks of
    ``q_tile`` queries and concatenate.  ``extras`` are per-query tensors
    (leading dimension n_q, e.g. each query's filter id) cut beside the
    queries.  The tail block is simply shorter: eager PyTorch has no
    compiled shape to keep."""
    n_q = queries.shape[0]
    if q_tile >= n_q:
        return run_fn(queries, *extras)
    vs, is_ = [], []
    for s in range(0, n_q, q_tile):
        v, i = run_fn(queries[s:s + q_tile], *(e[s:s + q_tile] for e in extras))
        vs.append(v)
        is_.append(i)
    return torch.cat(vs), torch.cat(is_)
