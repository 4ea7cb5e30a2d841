"""Peaks of the card and the arithmetic that the per-layer readers share.

A stage's roofline share is the least time the card could take for the
stage's compulsory bytes (each input read once, each output written once,
at the batch's padded shapes) over the device time its kernels took, summed
over the traced window's recorded launches. The bytes of each kernel live
in the metric's own file; this module pairs them with the trace.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent / "peaks.json"
OFFSETS_KERNEL = "segment_offsets"


def peaks(ctx) -> dict:
    """The peak rates of the run's card (``peaks.json``, by its name)."""
    import torch

    name = torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu"
    table = json.loads(PEAKS.read_text())
    for entry in table["cards"]:
        if all(word in name for word in entry["match"]):
            return entry
    return table["default"]


def matches(name: str, kernels) -> str | None:
    return next((k for k in kernels if k in name), None)


def launch_sequences(trace):
    """Per span: (index, [(launch, device record or None)] in host order)."""
    dev = trace.device_by_corr()
    out = []
    for i, span in enumerate(trace.spans()):
        seq = sorted(trace.launches_in(span), key=lambda r: r.start)
        out.append((i, [(launch, dev.get(launch.corr)) for launch in seq]))
    return out


def stage_seconds(seq, kernels) -> list:
    """[(kernel key, seconds)] of the stage's recorded kernels in one span's
    launch sequence, each with the offsets pass launched just before it by
    the same call (the pass is shared code; it belongs to the kernel that
    follows it)."""
    out = []
    for k, (_, rec) in enumerate(seq):
        key = rec and matches(rec.name, kernels)
        if not key:
            continue
        seconds = (rec.end - rec.start) / 1e9
        if k > 0 and seq[k - 1][1] is not None and OFFSETS_KERNEL in seq[k - 1][1].name:
            prev = seq[k - 1][1]
            seconds += (prev.end - prev.start) / 1e9
        out.append((key, seconds))
    return out


def share(trace, ctx, bytes_of: dict) -> float | None:
    """Roofline share (%) of the kernels keyed in ``bytes_of`` (key ->
    function of a span's work giving one call's compulsory bytes), over
    every recorded launch of the traced window; None when none ran."""
    bandwidth = peaks(ctx)["bytes_per_s"]
    bound = spent = 0.0
    for i, seq in launch_sequences(trace):
        for key, seconds in stage_seconds(seq, bytes_of):
            bound += bytes_of[key](trace.work[i]) / bandwidth
            spent += seconds
    return 100.0 * bound / spent if spent > 0 else None


def model_flops(cfg: dict, work: dict) -> float:
    """Matrix-product FLOPs (2 m n k) of one forward evaluation at a span's
    real sizes: every dense layer of the configuration and the three-body
    stage's contraction in its mode (the factorized stage's scatter and
    gather, 2 x l^2 n per edge each; the per-triplet gate-sum, l n per
    triplet). Elementwise work is left out."""
    d, n = cfg["embedding_dim"], cfg["n_max"]
    ln, mn = cfg["l_max"] * n, cfg["l_max"] ** 2 * n
    nodes, edges, trip = work["atoms"], work["edges"], work["triplets"]
    per_edge = 2 * n * d  # edge_init
    per_node = 0
    for _ in range(cfg["num_blocks"]):
        per_node += 2 * d * ln  # three_gate
        per_edge += 2 * 2 * ln * d  # three_mlp: dense and gate
        per_edge += 2 * 2 * (2 * 3 * d * d + 2 * d * d)  # conv_edge, conv_node: two layers each
        per_edge += 2 * 2 * n * d  # conv_edge_w, conv_node_w
        per_edge += 2 * 2 * mn if cfg["threebody_mode"] == "factorized" else 0
    per_node += 2 * 2 * (d * d + d * d + d)  # readout: dense and gate, three layers
    stage = 0 if cfg["threebody_mode"] == "factorized" else cfg["num_blocks"] * 2 * ln * trip
    return per_node * nodes + per_edge * edges + stage


def on_device(trace) -> bool:
    return any(r.kind in ("kernel", "memcpy", "memset") for r in trace.records)


def mfu(trace, ctx, passes: int) -> float | None:
    """The traced spans' matrix-product FLOPs (each step's forward count
    times ``passes``, the forward counts that one step takes) over their
    host-clock time, as a share (%) of the card's peak in the
    configuration's dtype."""
    spans = trace.spans()
    if not spans or not on_device(trace):
        return None
    flops = sum(model_flops(ctx.config, w) * passes * w["steps"] for w in trace.work)
    seconds = sum(s.end - s.start for s in spans) / 1e9
    return 100.0 * flops / seconds / peaks(ctx)[ctx.config["peak"] + "_flops_per_s"]


def idle_share(trace) -> float | None:
    """1 - the union of the device's busy intervals over the traced window
    (the first span's start to the last span's end), in %."""
    if not trace.spans() or not on_device(trace):
        return None
    t0, t1 = trace.window()
    return 100.0 * (1.0 - trace.busy(t0, t1) / ((t1 - t0) / 1e9))


def launches_per_step(trace) -> float | None:
    """Kernel launches (the host's runtime launch records, every kernel,
    torch's too) per step of the traced spans."""
    spans = trace.spans()
    if not spans or not trace.of("launch"):
        return None
    launches = sum(len(trace.launches_in(s)) for s in spans)
    return launches / sum(w["steps"] for w in trace.work)
