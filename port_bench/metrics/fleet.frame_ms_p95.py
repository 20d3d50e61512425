"""The 95th percentile, over every untraced fleet frame of the window, of
the time from its ``process_batch`` call until the benchmark saw its poses
in ``pose_log`` (host clock)."""


def read(run):
    return run.window.get("frame_ms_p95")
