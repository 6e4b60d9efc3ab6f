"""mimi.attn_roofline: One attention call's least time over its mean
device time, in the profiled sub-window. A call is one of the program's
`mimi.attention` spans (a layer's attention over its ring KV cache, the
ring write included); its device time is that of the operations launched
inside it. The least time is the larger of the call's bytes (the ring's
K and V read once for every stream, q, the new k / v rows and the output
once) over HBM's peak and its FLOPs over the f32 peak, both from
`reference/mimi_ref.attention_call_work` at the configuration's widths
and the stream count. A program without the span reads as nothing."""

from benchmark import spans

LAYER = "transformer"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "stream_rtf"
SPAN = "mimi.attention"


def read(rec):
    tr = rec.get("trace")
    if tr is None or rec.get("peaks") is None or "attn_work" not in rec:
        return None
    lo, hi = tr.window
    calls = sum(1 for name, ts, dur in tr.spans
                if name == SPAN and lo <= ts and ts + dur <= hi)
    ops = spans.launched_in(tr, (SPAN,))
    if not calls or not ops:
        return None
    mean_s = 1e-6 * sum(op[2] for op in ops) / calls
    flops, nbytes = rec["attn_work"]
    pk = rec["peaks"]
    least = max(flops / pk["bf16" if rec.get("precision") == "bf16"
                            else "f32"], nbytes / pk["hbm"])
    return 100.0 * least / mean_s
