"""Statically padded crystal-graph batches (host side) and their transfer.

Own copy of ``torch_m3gnet_tpu.data.graph`` without ``flax.struct``:
:class:`GraphBatch` is a plain frozen dataclass whose fields are numpy
arrays on the host, or torch tensors after :func:`to_torch`.

Index/mask conventions:
- padded nodes/edges/triplets have mask 0; every scatter multiplies by the
  mask so padding contributes exactly zero,
- padded edges keep ``edge_src`` sorted (they point at the last node),
  ``edge_dst = 0`` and a zero cell shift; the model gives them distance
  ``cutoff`` so r-division is safe,
- padded graphs get the identity lattice (volume 1) so stress division is safe.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np

from torch_m3gnet_tpu_torch.data.neighborlist import neighbor_list_pbc
from torch_m3gnet_tpu_torch.data.structure import Structure
from torch_m3gnet_tpu_torch.data.triplets import compute_threebody

# Index fields: int32 on the host, contiguous int32 tensors on the device.
INDEX_FIELDS = (
    "atom_types", "node_graph", "edge_src", "edge_dst", "triplet_e1",
    "triplet_e2", "n_node", "triplet_node_k", "halo_send_idx", "halo_recv_idx", "edge_reverse",
    "edge_src_offsets", "triplet_e1_offsets", "triplet_e2_order", "triplet_e2_offsets",
)
# The per-batch index of the kernels, built by to_torch (None on the host).
BATCH_INDEX_FIELDS = INDEX_FIELDS[-4:]
# Index fields built at pack time that a model may name in its batch_index:
# to_torch copies them and refuses a batch without them.
PACKED_INDEX_FIELDS = ("edge_reverse",)
# The fields that the index is built from: replacing one (or the node
# count) drops the index that a batch carries.
_INDEX_SOURCES = ("edge_src", "triplet_e1", "triplet_e2")
# Plain Python values, neither arrays nor tensors: kept as they are.
STATIC_FIELDS = ("halo_offsets", "num_graphs_real")


@dataclass(frozen=True)
class GraphBatch:
    """A batch of periodic crystal graphs as one padded set of arrays.

    Shapes: N = padded nodes, E = padded edges, T = padded triplets,
    B = padded graphs.
    """

    # nodes
    positions: Any  # (N, 3) float cartesian, Angstrom
    atom_types: Any  # (N,) i32, 0-indexed Z
    node_graph: Any  # (N,) i32 graph id of each node
    node_mask: Any  # (N,) bool

    # edges: r_ij = pos[dst] + shift @ lattice[graph] - pos[src]
    edge_src: Any  # (E,) i32, sorted
    edge_dst: Any  # (E,) i32
    edge_cell_shift: Any  # (E, 3) float, integer-valued
    edge_mask: Any  # (E,) bool

    # triplets: ordered pairs of edges sharing a source node
    triplet_e1: Any  # (T,) i32 edge id of i->j
    triplet_e2: Any  # (T,) i32 edge id of i->k
    triplet_mask: Any  # (T,) bool

    # graphs
    lattice: Any  # (B, 3, 3) float row-wise
    graph_mask: Any  # (B,) bool
    n_node: Any  # (B,) i32 real nodes per graph

    # optional targets
    energy: Optional[Any] = None  # (B,) total energy, eV
    forces: Optional[Any] = None  # (N, 3) eV/Angstrom
    stress: Optional[Any] = None  # (B, 6) Voigt [xx,yy,zz,yz,zx,xy], eV/A^3

    # node k = edge_dst[triplet_e2], precomputed at pack time
    triplet_node_k: Optional[Any] = None  # (T,) i32

    # The bond pairs (``bond_pairs=True`` at pack time; None otherwise): for
    # every edge i->j at image shift S the id of its reverse j->i at -S, so
    # that the two directed edges of one undirected bond find each other
    # (CHGNet keeps one feature per bond). A padded edge is its own reverse.
    edge_reverse: Optional[Any] = None  # (E,) i32

    # The per-batch index of the kernels, built by to_torch once per batch
    # (None on the host), each part only where the model's mode reads it,
    # and the only source of them: the run offsets of the sorted edge_src
    # and triplet_e1 (ops.sorted_segment.sorted_segment_offsets), along
    # which every sorted kernel sums by them, and the e2 order
    # (ops.fused_triplet.triplet_e2_order), along which the kernels sum by
    # triplet_e2: the stable permutation that sorts triplet_e2, and each
    # edge's run [off[e], off[e+1]) of it.
    edge_src_offsets: Optional[Any] = None  # (N + 1,) i32
    triplet_e1_offsets: Optional[Any] = None  # (E + 1,) i32
    triplet_e2_order: Optional[Any] = None  # (T,) i32
    triplet_e2_offsets: Optional[Any] = None  # (E + 1,) i32

    # The graph-parallel halo plan of one shard (parallel.graph_shard.
    # partition_graph; ops.halo): the local rows it sends, in one block of Hp
    # rows per ring offset, and for each of its H halo slots the row of the
    # received blocks that holds it. With a plan, edge_dst and triplet_node_k
    # are extended-local ids in [0, N + H): local rows, then halo slots.
    halo_send_idx: Optional[Any] = None  # (n_offsets * Hp,) i32
    halo_recv_idx: Optional[Any] = None  # (H,) i32
    halo_offsets: tuple = ()  # the ring offsets with traffic, one block each

    num_graphs_real: int = 0

    @property
    def num_nodes(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def num_triplets(self) -> int:
        return int(self.triplet_e1.shape[0])

    @property
    def num_graphs(self) -> int:
        return int(self.lattice.shape[0])

    def replace(self, **kwargs: Any) -> "GraphBatch":
        """A copy with ``kwargs`` replaced. A new ``edge_src``,
        ``triplet_e1`` or ``triplet_e2``, or positions with another node
        count, drops the kernel index built from the old ones (the index
        fields not given in ``kwargs`` become None; ``to_torch`` builds them
        anew)."""
        positions = kwargs.get("positions")
        if any(k in kwargs for k in _INDEX_SOURCES) or (
                positions is not None and positions.shape[0] != self.num_nodes):
            kwargs = {**dict.fromkeys(BATCH_INDEX_FIELDS), **kwargs}
        return dataclasses.replace(self, **kwargs)

    def row(self, i: int) -> "GraphBatch":
        """Row ``i`` of a batch stacked along a leading axis (a device's
        shard of ``parallel.graph_shard.partition_graph`` or of
        ``parallel.dp.shard_stack``): every array field indexed at ``i``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[i] for f in dataclasses.fields(self)
            if f.name not in STATIC_FIELDS and getattr(self, f.name) is not None})


def stack_rows(rows: Sequence[GraphBatch], **static) -> GraphBatch:
    """Host batches of identical shapes stacked along a new leading axis;
    ``static`` replaces static fields of the first row (each row's must
    otherwise agree)."""
    first = rows[0]
    return dataclasses.replace(first, **static, **{
        f.name: np.stack([np.asarray(getattr(r, f.name)) for r in rows])
        for f in dataclasses.fields(first)
        if f.name not in STATIC_FIELDS and getattr(first, f.name) is not None})


def graph_from_structure(
    structure: Structure,
    cutoff: float,
    threebody_cutoff: float,
    dtype=np.float32,
    use_native: bool | None = None,
    bond_pairs: bool = False,
) -> GraphBatch:
    """Build a single (unpadded) graph from a crystal structure: full PBC
    neighbor list at ``cutoff``, triplets among edges within
    ``threebody_cutoff``, 0-indexed atomic numbers. ``use_native`` picks
    the path of both host searches (``neighbor_list_pbc``,
    ``compute_threebody``); the paths give the same graph. ``bond_pairs``
    adds ``edge_reverse`` (:func:`reverse_edges`)."""
    if threebody_cutoff > cutoff:
        raise ValueError("threebody_cutoff must be <= cutoff")
    edge_index, shift, dist = neighbor_list_pbc(
        structure.lattice, structure.cart_coords, cutoff, use_native=use_native
    )
    n = len(structure)
    tei, _, _ = compute_threebody(n, edge_index, dist, threebody_cutoff, use_native=use_native)

    props = structure.properties
    energy = props.get("energy")
    forces = props.get("forces")
    stress = props.get("stress")
    if forces is not None:
        fsize = np.asarray(forces).size
        if fsize != 3 * n:
            raise ValueError(
                f"forces target has {fsize // 3 if fsize % 3 == 0 else fsize / 3} "
                f"rows for a {n}-atom structure"
            )

    return GraphBatch(
        positions=structure.cart_coords.astype(dtype),
        atom_types=(structure.atomic_numbers - 1).astype(np.int32),
        node_graph=np.zeros(n, dtype=np.int32),
        node_mask=np.ones(n, dtype=bool),
        edge_src=edge_index[0].astype(np.int32),
        edge_dst=edge_index[1].astype(np.int32),
        edge_cell_shift=shift.astype(dtype),
        edge_mask=np.ones(edge_index.shape[1], dtype=bool),
        triplet_e1=tei[0].astype(np.int32),
        triplet_e2=tei[1].astype(np.int32),
        triplet_mask=np.ones(tei.shape[1], dtype=bool),
        triplet_node_k=edge_index[1][tei[1]].astype(np.int32),
        edge_reverse=reverse_edges(edge_index[0], edge_index[1], shift) if bond_pairs else None,
        lattice=structure.lattice.astype(dtype)[None],
        graph_mask=np.ones(1, dtype=bool),
        n_node=np.array([n], dtype=np.int32),
        energy=None if energy is None else np.asarray([energy], dtype=dtype),
        forces=None if forces is None else np.asarray(forces, dtype=dtype),
        stress=None
        if stress is None
        else np.asarray(stress, dtype=dtype).reshape(1, 6),
        num_graphs_real=1,
    )


def reverse_edges(edge_src, edge_dst, shift) -> np.ndarray:
    """(E,) int32: for every edge i->j at image shift S the id of the edge
    j->i at -S. A full periodic neighbour list holds both; an edge without
    its reverse raises."""
    src, dst = np.asarray(edge_src, np.int64), np.asarray(edge_dst, np.int64)
    s = np.rint(np.asarray(shift, np.float64)).astype(np.int64).reshape(-1, 3)
    if src.size == 0:
        return np.zeros(0, np.int32)
    span = int(np.abs(s).max())
    width, n = 2 * span + 1, int(max(src.max(), dst.max())) + 1

    def code(a, b, sh):  # one int64 per (source, destination, shift)
        c = a * n + b
        for k in range(3):
            c = c * width + sh[:, k] + span
        return c

    keys = code(src, dst, s)
    order = np.argsort(keys, kind="stable")
    want = code(dst, src, -s)
    at = np.minimum(np.searchsorted(keys[order], want), keys.size - 1)
    if not np.array_equal(keys[order][at], want):
        bad = int(np.nonzero(keys[order][at] != want)[0][0])
        raise ValueError(f"edge {bad} ({src[bad]} -> {dst[bad]} at shift {s[bad].tolist()}) "
                         f"has no reverse edge in the neighbour list")
    return order[at].astype(np.int32)


def _all_or_none(graphs: Sequence[GraphBatch], attr: str) -> bool:
    vals = [getattr(g, attr) is not None for g in graphs]
    if all(vals):
        return True
    if not any(vals):
        return False
    raise ValueError(f"Inconsistent presence of target '{attr}' across graphs")


def batch_graphs(graphs: Sequence[GraphBatch]) -> GraphBatch:
    """Concatenate graphs into one batch: edge endpoints offset by the node
    count, triplet edge ids by the edge count of preceding graphs."""
    node_off = 0
    edge_off = 0
    graph_off = 0
    cols: dict[str, list] = {k: [] for k in (
        "positions", "atom_types", "node_graph", "node_mask",
        "edge_src", "edge_dst", "edge_cell_shift", "edge_mask",
        "triplet_e1", "triplet_e2", "triplet_mask", "triplet_node_k",
        "lattice", "graph_mask", "n_node", "energy", "forces", "stress", "edge_reverse",
    )}
    has = {k: _all_or_none(graphs, k) for k in ("energy", "forces", "stress")}
    pairs = _all_or_none(graphs, "edge_reverse")

    for g in graphs:
        cols["positions"].append(g.positions)
        cols["atom_types"].append(g.atom_types)
        cols["node_graph"].append(g.node_graph + graph_off)
        cols["node_mask"].append(g.node_mask)
        cols["edge_src"].append(g.edge_src + node_off)
        cols["edge_dst"].append(g.edge_dst + node_off)
        cols["edge_cell_shift"].append(g.edge_cell_shift)
        cols["edge_mask"].append(g.edge_mask)
        cols["triplet_e1"].append(g.triplet_e1 + edge_off)
        cols["triplet_e2"].append(g.triplet_e2 + edge_off)
        cols["triplet_mask"].append(g.triplet_mask)
        cols["triplet_node_k"].append(
            (g.triplet_node_k if g.triplet_node_k is not None
             else np.asarray(g.edge_dst)[np.asarray(g.triplet_e2)]) + node_off
        )
        cols["lattice"].append(g.lattice)
        cols["graph_mask"].append(g.graph_mask)
        cols["n_node"].append(g.n_node)
        for k, present in has.items():
            if present:
                cols[k].append(getattr(g, k))
        if pairs:
            cols["edge_reverse"].append(g.edge_reverse + edge_off)
        node_off += g.num_nodes
        edge_off += g.num_edges
        graph_off += g.num_graphs

    cat = {k: (np.concatenate(v) if v else None) for k, v in cols.items()}
    return GraphBatch(**cat, num_graphs_real=sum(g.num_graphs_real for g in graphs))


def cast_batch(batch: GraphBatch, dtype) -> GraphBatch:
    """The host batch with its floating-point fields cast to ``dtype`` (for
    example float64 for the second-derivative routines of ``simulate``)."""

    def cast(a):
        if a is not None and np.issubdtype(np.asarray(a).dtype, np.floating):
            return np.asarray(a, dtype=dtype)
        return a

    return dataclasses.replace(batch, **{
        f.name: cast(getattr(batch, f.name)) for f in dataclasses.fields(GraphBatch)
        if f.name != "num_graphs_real"})


def triplet_counts(batch: GraphBatch) -> tuple[np.ndarray, np.ndarray]:
    """Per-node and per-edge triplet counts, recovered from the batch:
    ``num_triplet_i[n]`` triplets centred on node n (d * (d - 1) for a node
    of 3-body degree d) and ``num_triplet_ij[e]`` triplets whose first edge
    is e (d(src) - 1 for an edge within the 3-body cutoff, else 0). Padded
    triplets are left out; the shapes are the padded N and E."""
    e1 = np.asarray(batch.triplet_e1)[np.asarray(batch.triplet_mask, bool)]
    num_edges = np.asarray(batch.edge_src).shape[-1]
    num_nodes = np.asarray(batch.positions).shape[-2]
    num_triplet_ij = np.bincount(e1, minlength=num_edges)
    num_triplet_i = np.bincount(np.asarray(batch.edge_src)[e1], minlength=num_nodes)
    return num_triplet_i, num_triplet_ij


def round_up(x: int, multiple: int) -> int:
    if multiple <= 1:
        return max(x, 1)
    return max(multiple, ((x + multiple - 1) // multiple) * multiple)


def pad_batch(
    batch: GraphBatch,
    max_nodes: int,
    max_edges: int,
    max_triplets: int,
    max_graphs: int,
) -> GraphBatch:
    """Pad a concatenated batch to static bucket sizes with zeroed masks."""
    n, e, t, b = batch.num_nodes, batch.num_edges, batch.num_triplets, batch.num_graphs
    if n > max_nodes or e > max_edges or t > max_triplets or b > max_graphs:
        raise ValueError(
            f"batch ({n} nodes, {e} edges, {t} triplets, {b} graphs) exceeds bucket "
            f"({max_nodes}, {max_edges}, {max_triplets}, {max_graphs})"
        )
    pn, pe, pt, pb = max_nodes - n, max_edges - e, max_triplets - t, max_graphs - b

    def pad0(a, count):
        if count == 0:
            return a
        widths = [(0, 0)] * a.ndim
        widths[0] = (0, count)
        return np.pad(a, widths)

    lattice = pad0(batch.lattice, pb)
    if pb:
        lattice[b:] = np.eye(3, dtype=lattice.dtype)

    def pad_last(a, count, value):
        """Pad an index field with ``value`` so sorted ids STAY sorted — the
        q_scatter kernel finds each node's edges by binary search; padded
        rows carry masked-zero data."""
        if count == 0:
            return a
        return np.concatenate([a, np.full(count, value, dtype=a.dtype)])

    return GraphBatch(
        positions=pad0(batch.positions, pn),
        atom_types=pad0(batch.atom_types, pn),
        node_graph=pad_last(batch.node_graph, pn, max_graphs - 1),
        node_mask=pad0(batch.node_mask, pn),
        edge_src=pad_last(batch.edge_src, pe, max_nodes - 1),
        edge_dst=pad0(batch.edge_dst, pe),
        edge_cell_shift=pad0(batch.edge_cell_shift, pe),
        edge_mask=pad0(batch.edge_mask, pe),
        triplet_e1=pad_last(batch.triplet_e1, pt, max_edges - 1),
        triplet_e2=pad0(batch.triplet_e2, pt),
        triplet_mask=pad0(batch.triplet_mask, pt),
        triplet_node_k=None
        if batch.triplet_node_k is None
        else pad0(batch.triplet_node_k, pt),
        edge_reverse=None if batch.edge_reverse is None else np.concatenate(
            [batch.edge_reverse, np.arange(e, max_edges, dtype=batch.edge_reverse.dtype)]),
        lattice=lattice,
        graph_mask=pad0(batch.graph_mask, pb),
        n_node=pad0(batch.n_node, pb),
        energy=None if batch.energy is None else pad0(batch.energy, pb),
        forces=None if batch.forces is None else pad0(batch.forces, pn),
        stress=None if batch.stress is None else pad0(batch.stress, pb),
        num_graphs_real=batch.num_graphs_real,
    )


def pack_structures(
    structures: Sequence[Structure],
    cutoff: float,
    threebody_cutoff: float,
    max_nodes: int | None = None,
    max_edges: int | None = None,
    max_triplets: int | None = None,
    max_graphs: int | None = None,
    pad_multiple: int = 128,
    dtype=np.float32,
    use_native: bool | None = None,
    bond_pairs: bool = False,
) -> GraphBatch:
    """Structures -> graphs -> concatenated -> padded batch in one call
    (``bond_pairs``: see :func:`graph_from_structure`)."""
    graphs = [graph_from_structure(s, cutoff, threebody_cutoff, dtype=dtype, use_native=use_native,
                                   bond_pairs=bond_pairs)
              for s in structures]
    cat = batch_graphs(graphs)
    return pad_batch(
        cat,
        max_nodes or round_up(cat.num_nodes + 1, pad_multiple),
        max_edges or round_up(cat.num_edges + 1, pad_multiple),
        max_triplets or round_up(cat.num_triplets + 1, pad_multiple),
        max_graphs or cat.num_graphs,
    )


def to_torch(batch, device, dtype=None, index=BATCH_INDEX_FIELDS,
             num_dst_nodes: int | None = None) -> GraphBatch:
    """Copy a batch to ``device`` as torch tensors.

    Index fields become contiguous int32 tensors (the CUDA kernels take
    int32), masks bool tensors, float fields keep their dtype unless
    ``dtype`` is given. Fields that are already tensors are moved, not
    copied, when they are in place. Any object with the fields of
    :class:`GraphBatch` is accepted.

    A host batch is checked once here for what the kernels rely on, on
    ``device`` after the copy and before any kernel reads an index
    (``ops.batch_check``: one kernel launch on CUDA, the plain version on
    the CPU; each index in the dtype it was given, so no value wraps into
    range before it is checked): ``edge_src`` sorted ascending, every
    source in [0, N); every destination (``edge_dst``,
    ``triplet_node_k``) in [0, D); ``triplet_e1`` sorted ascending, every
    edge index in [0, E); ``node_graph`` sorted ascending, every graph
    index in [0, B) (the strain stress sums by ``edge_graph =
    node_graph[edge_src]``, sorted only if ``node_graph`` is); ``edge_reverse``, where the
    batch has it, in [0, E). D is N, or ``num_dst_nodes`` where the caller gives
    it (a shard of the all-gather partition addresses the global nodes);
    for a shard with a halo plan D is N + H, its extended-local ids, and
    ``halo_send_idx`` must lie in [0, N) and ``halo_recv_idx`` in the
    received blocks, [0, n_offsets * Hp).

    ``index`` names the parts of the kernels' per-batch index to build
    (of ``BATCH_INDEX_FIELDS``: the offsets of ``edge_src`` and
    ``triplet_e1``, and the e2 order, ``triplet_e2_order`` with
    ``triplet_e2_offsets``), on ``device`` from the copied indices: device
    searches, and one stable device sort for the e2 order. The potential
    asks for those its three-body mode reads (``M3GNet.batch_index``). A
    host batch gets the named parts and no other; a tensor batch keeps the
    index it carries and gets the named parts it lacks
    (``GraphBatch.replace`` drops an index whose sources it replaces).
    ``index`` may also name ``edge_reverse`` (``CHGNet.batch_index``),
    which pack time builds (``bond_pairs=True``): a batch without it is
    refused.
    """
    import torch

    from torch_m3gnet_tpu_torch.utils.profiling import count, span

    unknown = set(index) - set(BATCH_INDEX_FIELDS) - set(PACKED_INDEX_FIELDS)
    if unknown:
        raise ValueError(f"unknown batch index fields {sorted(unknown)}")
    if "edge_reverse" in index and getattr(batch, "edge_reverse", None) is None:
        raise ValueError("the model reads the batch's edge_reverse: pack it with "
                         "bond_pairs=True")
    with span("m3gnet.to_torch"):
        host = not isinstance(batch.edge_src, torch.Tensor)
        if host:
            count("to_torch.host_batches")

        def conv(name, a):
            if a is None or name in STATIC_FIELDS:
                return a
            if name in BATCH_INDEX_FIELDS and host:  # built below from the copied indices
                return None
            if not isinstance(a, torch.Tensor):
                count("to_torch.host_bytes", np.asarray(a).nbytes)
            t = torch.as_tensor(a, device=device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t

        with span("m3gnet.to_torch.copy"):
            fields = {f.name: conv(f.name, getattr(batch, f.name, None))
                      for f in dataclasses.fields(GraphBatch) if hasattr(batch, f.name)}
        if host:
            with span("m3gnet.to_torch.check"):
                _check_host_batch(fields, num_dst_nodes)
        # the kernels take int32: exact for a checked index, which lies in [0, bound)
        out = GraphBatch(**{name: t.to(torch.int32).contiguous()
                            if name in INDEX_FIELDS and t is not None else t
                            for name, t in fields.items()})
        from torch_m3gnet_tpu_torch.ops.fused_triplet import triplet_e2_order
        from torch_m3gnet_tpu_torch.ops.sorted_segment import sorted_segment_offsets

        built = {}
        with span("m3gnet.to_torch.index"):
            if "edge_src_offsets" in index and out.edge_src_offsets is None:
                built["edge_src_offsets"] = sorted_segment_offsets(out.edge_src, out.num_nodes)
            if "triplet_e1_offsets" in index and out.triplet_e1_offsets is None:
                built["triplet_e1_offsets"] = sorted_segment_offsets(out.triplet_e1,
                                                                     out.num_edges)
            if {"triplet_e2_order", "triplet_e2_offsets"} & set(index) and (
                    out.triplet_e2_order is None or out.triplet_e2_offsets is None):
                built["triplet_e2_order"], built["triplet_e2_offsets"] = triplet_e2_order(
                    out.triplet_e2, out.num_edges)
        return out.replace(**built) if built else out


def _check_host_batch(fields, num_dst_nodes: int | None) -> None:
    """Raise where a host batch, copied to its device as ``fields``, breaks
    what the kernels rely on (the rules of :func:`to_torch`): shapes here,
    every index value on the device (``ops.batch_check``)."""
    from torch_m3gnet_tpu_torch.ops.batch_check import IndexRule, check_indices
    from torch_m3gnet_tpu_torch.utils.profiling import count

    src = fields["edge_src"]
    n, nb, num_edges = fields["positions"].shape[0], fields["lattice"].shape[0], src.numel()
    send = fields.get("halo_send_idx")
    n_dst = num_dst_nodes or n
    rules = []
    if send is not None:
        recv, n_off = fields["halo_recv_idx"], len(fields["halo_offsets"])
        n_dst = n + recv.numel()
        if (send.numel() % n_off if n_off else send.numel()):
            raise ValueError(f"halo_send_idx holds {send.numel()} rows, not one block "
                             f"per ring offset of {fields['halo_offsets']}")
        rules += [IndexRule("halo_send_idx", send, n, False, "a row"),
                  IndexRule("halo_recv_idx", recv, send.numel(), False, "a row")]
    rules += [IndexRule("edge_src", src, n, True, "a node index"),
              IndexRule("edge_dst", fields["edge_dst"], n_dst, False, "a node index"),
              IndexRule("triplet_node_k", fields.get("triplet_node_k"), n_dst, False,
                        "a node index"),
              IndexRule("triplet_e1", fields["triplet_e1"], num_edges, True, "an edge index"),
              IndexRule("triplet_e2", fields["triplet_e2"], num_edges, False, "an edge index"),
              IndexRule("node_graph", fields["node_graph"], nb, True, "a graph index")]
    if fields.get("edge_reverse") is not None:
        rules.append(IndexRule("edge_reverse", fields["edge_reverse"], num_edges, False,
                               "an edge index"))
    count(f"to_torch.checks.{src.device.type}")
    check_indices(rules)
