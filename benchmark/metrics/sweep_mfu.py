"""The whole ViViT sweep's share of the chip's bf16 tensor peak: the
configuration's model operations of the traced shots (``counts sweep_ops``:
K1's table, the embedding and the windows) over the traced window (%)."""


def read(run):
    if run.trace is None or not run.counters.get("shots"):
        return None
    img, seq = run.counters["image_size"], run.cfg["program_config"]["n_frames"]
    ops = sum(run.counts.sweep_ops(run.cfg, img, t, max(t - seq, 0))
              for t in run.counters["shots"])
    return 100.0 * ops / (run.trace.window_s * run.peaks.BF16_TENSOR_OPS_PER_S)
