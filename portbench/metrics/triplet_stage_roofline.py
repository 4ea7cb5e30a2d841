"""Roofline share (%) of the per-triplet three-body stage, kernels B4-B7
(``ops/fused_triplet.py``, ``ops/windowed_take.py``), in the traced window.

Compulsory bytes of one call at the batch's padded shapes (E edges, T
triplets), float32 values and int32 indices, each input read once and each
output written once (the counts of ``time_kernels`` in ``chip_smoke.py``),
ln = l_max n_max, f = 4 geometry rows ([x, y, z, |r|]):

- ``fused_triplet_gate_sum_kernel`` (B4): basis (ln, T), e1 and e2 (T
  each), the edge gate (ln, E) read, (ln, E) written:
  4 ln T + 8 T + 8 ln E;
- ``backward_pair_kernel`` (B5): basis (ln, T) read and d_basis (ln, T)
  written, e1 and e2 read, the gate and the cotangent (ln, E) read and
  d_gate (ln, E) written: 8 ln T + 8 T + 12 ln E;
- ``windowed_take_kernel`` (B6): (f, E) and the index (T) read, (f, T)
  written: 4 f E + 4 T + 4 f T;
- ``windowed_scatter_owned`` (B7): (f, T) and the index read, (f, E)
  written: 4 f T + 4 T + 4 f E.

B4's offsets pass counts in B4's time.
"""

from portbench import roofline

ROWS = 4


def read(trace, ctx):
    ln, f = ctx.config["l_max"] * ctx.config["n_max"], ROWS
    te = lambda w: (w["triplets_pad"], w["edges_pad"])
    return roofline.share(trace, ctx, {
        "fused_triplet_gate_sum_kernel": lambda w: 4 * ln * te(w)[0] + 8 * te(w)[0]
        + 8 * ln * te(w)[1],
        "backward_pair_kernel": lambda w: 8 * ln * te(w)[0] + 8 * te(w)[0] + 12 * ln * te(w)[1],
        "windowed_take_kernel": lambda w: 4 * f * te(w)[1] + 4 * te(w)[0] + 4 * f * te(w)[0],
        "windowed_scatter_owned": lambda w: 4 * f * te(w)[0] + 4 * te(w)[0] + 4 * f * te(w)[1],
    })
