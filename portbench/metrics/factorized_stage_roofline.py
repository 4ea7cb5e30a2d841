"""Roofline share (%) of the factorized three-body stage, kernels B1-B3
(``ops/factorized_stage.py``), in the traced window.

Compulsory bytes of one call at the batch's padded shapes (N nodes, E
edges), each input read once and each output written once, float32 and
int32 (the counts of ``time_kernels`` in ``chip_smoke.py``), with
m = l_max^2 harmonics, ln = l_max n_max factors and mn = m n_max:

- ``q_scatter_kernel`` (B1): sh (m, E) and gm (ln, E) read, the edges'
  sources (E) read, A (mn, N) written: 4 (m + ln) E + 4 E + 4 mn N;
- ``r1_gather_kernel`` (B2): A (mn, N), sh (m, E) and the sources read,
  (ln, E) written: 4 mn N + 4 (m + ln) E + 4 E;
- ``r2_gather_kernel`` (B3): A, gm (ln, E) and the sources read, (m, E)
  written: the same count.

B1's offsets pass (``segment_offsets``, launched by the same call) counts
in B1's time. An operand under the 50 MB L2 may be read from it: a share
above 100 % would mean that the count is too high, not a fast kernel.
"""

from portbench import roofline


def read(trace, ctx):
    cfg = ctx.config
    m, ln = cfg["l_max"] ** 2, cfg["l_max"] * cfg["n_max"]
    mn = m * cfg["n_max"]
    gather = lambda w: 4 * mn * w["nodes"] + 4 * (m + ln) * w["edges_pad"] + 4 * w["edges_pad"]
    return roofline.share(trace, ctx, {
        "q_scatter_kernel": lambda w: (4 * (m + ln) * w["edges_pad"] + 4 * w["edges_pad"]
                                       + 4 * mn * w["nodes"]),
        "r1_gather_kernel": gather,
        "r2_gather_kernel": gather,
    })
