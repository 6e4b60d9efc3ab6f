"""optim.fused_share.train: The share of AdamP's leaf updates in this
process that the program's multi-leaf kernel made, against its plain
per-leaf path (`hilcodec_tpu_torch/train/optim.fused_record`): 100 x
fused / (fused + plain) leaves, over set-up, the window and the profiled
steps. A program without the counter reads as nothing."""

LAYER = "train step"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "train_audio_s_per_s"


def read(rec):
    from hilcodec_tpu_torch.train import optim
    reader = getattr(optim, "fused_record", None)
    if reader is None:
        return None
    counts = reader()
    total = counts.get("fused", 0) + counts.get("plain", 0)
    return 100.0 * counts.get("fused", 0) / total if total else None
