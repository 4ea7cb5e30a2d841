"""Roofline share (%) of CHGNet's norm-and-gate kernels
(``ops/norm_gate.py``, ``csrc/norm_gate.cu``) in the traced E/F/S requests.

Each of CHGNet's gated MLPs ends in one forward call (``norm_gate_fwd``)
and, in the force backward, one backward call (``norm_gate_bwd``, whose
second pass ``norm_gate_param_sums`` sums the parameters' gradients): the
num_blocks atom convs over the padded edges, and the num_blocks - 1 bond
convs and num_blocks - 2 angle updates over the padded angles, 2 (3
num_blocks - 3) calls a request. Compulsory bytes of one column, F =
``embedding_dim`` features: the forward reads the two pre-norm stacks and
writes the output (12 F), the backward reads the gradient and both stacks
and writes both stacks' gradients (20 F): 32 F (num_blocks ``edges_pad`` +
(2 num_blocks - 3) ``triplets_pad``) bytes a request, over the recorded
device time of both kernels and the second pass.

The device records do not say which call a launch was, so only requests
whose every launch has its record are read (``Trace.complete``), and only
where they hold exactly the 2 (3 num_blocks - 3) calls; with none left (a
program without these kernels, or M3GNet) the reader returns nothing.
"""

from portbench import roofline

CALLS = ("norm_gate_fwd", "norm_gate_bwd")
KERNELS = (*CALLS, "norm_gate_param_sums")


def read(trace, ctx):
    cfg = ctx.config
    f, blocks = cfg["embedding_dim"], cfg["num_blocks"]
    bandwidth = roofline.peaks(ctx)["bytes_per_s"]
    bound = spent = 0.0
    for i, _, kernels in trace.complete():
        w = trace.work[i]
        found = roofline.stage_seconds([(None, k) for k in kernels], KERNELS)
        if sum(key in CALLS for key, _ in found) != 2 * (3 * blocks - 3):
            continue
        bound += 32 * f * (blocks * w["edges_pad"] + (2 * blocks - 3) * w["triplets_pad"]) / bandwidth
        spent += sum(seconds for _, seconds in found)
    return 100.0 * bound / spent if spent > 0 else None
