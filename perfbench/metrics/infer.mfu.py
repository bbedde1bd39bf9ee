"""``infer.mfu``: the layer-wise passes' floating-point work over the
traced window, over what the card's float32 peak does in the window's
seconds, in percent. Per layer of ``N`` nodes, ``E`` edges and widths
``f -> g``: ``E * f`` adds and ``N * f`` divides of the mean, ``4 * N * f *
g`` for the two linear maps, ``2 * N * g`` for the bias and their sum;
ReLU and the log-softmax are not counted."""


def layerwise_flops(num_nodes: int, num_edges: int, widths) -> int:
    n, e = num_nodes, num_edges
    return sum(e * f + n * f + 4 * n * f * g + 2 * n * g
               for f, g in zip(widths[:-1], widths[1:]))


def read(rec):
    tr, peaks = rec.get("trace"), rec.get("peaks")
    if tr is None or peaks is None or tr.window_s <= 0 or not rec.get("passes"):
        return None
    work = rec["passes"] * layerwise_flops(rec["num_nodes"], rec["num_edges"], rec["widths"])
    return 100.0 * work / (tr.window_s * peaks["f32_flops_per_s"])
