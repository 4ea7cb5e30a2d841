"""Roofline share (%) of the sorted sums, kernel B8
(``ops/sorted_segment.py``), in the traced E/F/S requests.

One E/F/S evaluation makes num_blocks + 2 sorted sums, in this order: the
node aggregation of each block (D rows of E edges into N nodes, by the
batch's offsets of ``edge_src``), the forces (3 rows into N, by the same
offsets), the strain stress (9 rows into the B graphs, by the edges' graph
ids, with an offsets pass of its own). Compulsory bytes of one sum of R
rows over M entries into S segments: 4 R M read, 4 (S + 1) offsets or 4 M
ids read, 4 R S written (``time_sorted_segment`` in ``chip_smoke.py``).

The device records do not say which sum a launch was, so only requests
whose every launch has its record are read (``Trace.complete``), and only
where they hold exactly num_blocks + 2 B8 launches; other requests are
left out, and with none left the reader returns nothing.
"""

from portbench import roofline

KERNELS = ("segment_sum_tiled", "segment_sum_block")


def read(trace, ctx):
    cfg = ctx.config
    d, blocks = cfg["embedding_dim"], cfg["num_blocks"]
    bandwidth = roofline.peaks(ctx)["bytes_per_s"]
    bound = spent = 0.0
    for i, _, kernels in trace.complete():
        w = trace.work[i]
        n, e, b = w["nodes"], w["edges_pad"], w["graphs_pad"]
        calls = roofline.stage_seconds([(None, k) for k in kernels], KERNELS)
        if len(calls) != blocks + 2:
            continue
        by_offsets = lambda rows, segs: 4 * rows * e + 4 * (segs + 1) + 4 * rows * segs
        nbytes = (blocks * by_offsets(d, n) + by_offsets(3, n)
                  + 4 * 9 * e + 4 * e + 4 * 9 * b)
        bound += nbytes / bandwidth
        spent += sum(seconds for _, seconds in calls)
    return 100.0 * bound / spent if spent > 0 else None
