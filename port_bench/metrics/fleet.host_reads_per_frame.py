"""Host reads of device values a fleet frame over the window (the program's
counter ``utils/sync.counts["host_syncs"]``, every shard's)."""


def read(run):
    return run.host_reads / run.frames if run.frames else None
